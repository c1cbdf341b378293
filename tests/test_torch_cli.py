"""The PyTorch port's CLI (speedy_tpu_torch/cli.py, --engine grid) and WAV
I/O (speedy_tpu_torch/io/wave.py) against the JAX package's, on the CPU.

The WAV files are written byte for byte as the JAX package writes them
and read back equal. The CLI writes exactly the samples of the port's
nonlinear_speedup on the same data, and they agree with the JAX CLI's
grid engine output up to float64 pitch ties (the gates of
tests/test_torch_single.py). What the port does not run yet (other
engines, --rate, dump files, multichannel input, a missing card) exits
with an argparse error and writes nothing.
"""

import numpy as np
import pytest
import torch

import speedy_tpu.profiling
from speedy_tpu import cli as jcli
from speedy_tpu import pipeline as jpipeline
from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.io import wave as jwave

from speedy_tpu_torch import SpeedyConfig, cli, nonlinear_speedup
from speedy_tpu_torch.io import read_wave, write_wave

from torch_port_util import assert_singles_agree, speech_families

SR = 16000


@pytest.fixture()
def wav(tmp_path):
    """A 2 s, 16 kHz speech-like mono WAV (family 1 of bench.py)."""
    path = tmp_path / "in.wav"
    write_wave(str(path), speech_families(2 * SR, SR, 2, seed=3)[1], SR)
    return path


@pytest.mark.parametrize("kind", ["int16-mono", "int16-stereo", "float-mono"])
def test_wave_round_trip_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    if kind == "float-mono":
        samples = rng.uniform(-1.0, 1.0, 3001).astype(np.float32)
    else:
        shape = (2000, 2) if kind == "int16-stereo" else (2001,)
        samples = rng.integers(-32768, 32768, shape).astype(np.int16)
    ours, theirs = tmp_path / "port.wav", tmp_path / "jax.wav"
    write_wave(str(ours), samples, 22050)
    jwave.write_wave(str(theirs), samples, 22050)
    assert ours.read_bytes() == theirs.read_bytes()
    got, sr = read_wave(str(ours))
    want, sr_j = jwave.read_wave(str(theirs))
    assert sr == sr_j == 22050 and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def _run(path, out, *args):
    return cli.main(["--input", str(path), "--output", str(out), "--engine", "grid",
                     "--device", "cpu", *args])


def test_cli_writes_the_pipeline_output(wav, tmp_path, capsys, monkeypatch):
    out = tmp_path / "out.wav"
    assert _run(wav, out, "-s", "3.0") == 0
    printed = capsys.readouterr().out
    y, sr = read_wave(str(out))
    samples, _ = read_wave(str(wav))
    cfg = SpeedyConfig(SR)
    rt = nonlinear_speedup(samples, cfg, 3.0, 1.0, 0.1, engine="grid", device="cpu")
    assert sr == SR
    np.testing.assert_array_equal(y, rt.output)
    assert f"Achieved overall compression: {len(samples) / len(y):.4f}x." in printed

    # The JAX CLI's grid engine on the same file. Its main() passes a dict
    # of five empty dump paths, which is truthy, so `--engine grid` there
    # always runs the streaming shim (speedy_tpu/cli.py:155-165); its
    # compress_sound without dump files runs the grid engine.
    monkeypatch.setattr(speedy_tpu.profiling, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(speedy_tpu.profiling, "honor_jax_platform_env", lambda: None)
    assert jcli.main(["--input", str(wav), "--output", str(tmp_path / "shim.wav"),
                      "--engine", "grid", "-s", "3.0"]) == 0
    assert "using the streaming engine" in capsys.readouterr().out
    out_j = tmp_path / "jax.wav"
    jcli.compress_sound(str(wav), 3.0, 1.0, 0.1, str(out_j), engine="grid")
    y_j, _ = read_wave(str(out_j))
    rj = jpipeline.nonlinear_speedup(samples, JConfig(SR), 3.0, 1.0, 0.1, engine="grid")
    np.testing.assert_array_equal(y_j, rj.output)
    x = samples.astype(np.float32) / 32768.0
    assert_singles_agree(
        x[None], [y_j / 32768.0], [y / 32768.0], [rj.speeds], [rt.speeds], cfg,
        [max(0.01, float(rj.speeds.min()) * 0.999)],
    )


def test_cli_match_nonlinear_and_length(wav, tmp_path, capsys):
    out = tmp_path / "out.wav"
    # A linear run at the nonlinear run's achieved rate (speedy_wave.cc's
    # use of --match_nonlinear) reaches that rate within 1.5%.
    assert _run(wav, out, "-s", "3.0", "--match_nonlinear", "--linear") == 0
    printed = capsys.readouterr().out
    matched = float(printed.split("Nonlinear run achieved ")[1].split("x")[0])
    assert "speeding up linearly" in printed
    y, _ = read_wave(str(out))
    assert abs(2 * SR / len(y) - matched) < 0.015 * matched

    assert _run(wav, out, "-s", "3.0", "--length", "0.8") == 0
    assert "Targeting 0.8s" in capsys.readouterr().out
    y, _ = read_wave(str(out))
    assert abs(len(y) / SR - 0.8) < 0.1  # speedy_wave.cc:428-462


@pytest.mark.parametrize("args", [
    ["--tension_file", "t.txt"],
    ["--features_file", "f.txt"],
    ["--rate", "1.5"],
    ["--engine", "scan"],
    ["--engine", "stream"],
])
def test_cli_refuses_what_is_not_ported(wav, tmp_path, capsys, args):
    out = tmp_path / "out.wav"
    with pytest.raises(SystemExit) as exc:
        _run(wav, out, "-s", "3.0", "--match_nonlinear", *args)
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err
    assert not out.exists()


def test_cli_refuses_multichannel_and_a_missing_card(tmp_path, capsys, monkeypatch):
    stereo = tmp_path / "stereo.wav"
    write_wave(str(stereo), np.zeros((4000, 2), np.int16), SR)
    out = tmp_path / "out.wav"
    with pytest.raises(SystemExit) as exc:
        _run(stereo, out)
    assert exc.value.code == 2 and "multichannel" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mono = tmp_path / "mono.wav"
    write_wave(str(mono), np.zeros(4000, np.int16), SR)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--input", str(mono), "--output", str(out), "--engine", "grid"])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
