"""The batch engine at 22.05 kHz, the reference's own test rate, on the CPU:
batched_nonlinear_speedup against the benchmark's plain float32 reference
(portbench/reference/plain.py, which imports nothing of the program), the
sizes the rate gives (W = 330 with the radix-11 FFT plan, step and hop
220, 285 lags, grid stride 768), and kernel 1's count of its plan as
launched (trace.PLANS).

There is no card here, so the plan tests fake kernel 1's launch as
tests/test_torch_batch_44k.py does: _on_cuda says yes, the bound table
holds a fake entry point that zeroes energy and lsd and reports the blocks
a row and the body's frames parameter, and the device and stream lookups
are stubs. The plan, the launch path and the counting are the program's
own."""

import ctypes
import json
import math
import pathlib

import pytest
import torch

import speedy_tpu_torch as port
from portbench import judge, traffic_gen
from portbench.reference import plain
from speedy_tpu_torch import trace
from speedy_tpu_torch.ops import _build, analysis_fft, kernels, wsola_fast
from speedy_tpu_torch.parallel import batch

SR = 22050
B, L = 4, 2 * SR
NL, FB, CAP = 1.0, 0.1, 1.33
BLOCKS = 5  # the blocks a row the faked launch reports


def _inputs(sr=SR, n=L):
    xs = torch.as_tensor(traffic_gen.families(n, sr))[torch.arange(B) % 4].contiguous()
    return xs, torch.linspace(0.5, 0.99, B)


@pytest.mark.parametrize("rate", [3.5, 2.0])
def test_batch_path_matches_the_plain_reference(rate):
    xs, gain = _inputs()
    res = port.batched_nonlinear_speedup(
        xs, torch.full((B,), L, dtype=torch.int32), port.SpeedyConfig(SR), rate, NL, FB,
        gain=gain, capacity_factor=CAP)
    ref = plain.Plain(SR).batch(xs, gain, rate, NL, FB, CAP)
    assert ref.output.shape == res.output.shape
    assert torch.equal(res.valid_length.to(torch.int64), ref.valid.to(torch.int64))
    assert bool((res.valid_length < res.output.shape[1]).all())
    tally = judge.Tally()
    tally.add(res.tension, ref.tension, res.speeds, ref.speeds, res.output, ref.output,
              res.valid_length, ref.valid)
    assert float(torch.cat(tally.tension).max()) < 2e-5
    assert float(torch.cat(tally.speeds).max()) < 2e-5
    assert tally.numbers()["audio_err_max"] < 1e-9


def test_the_rates_sizes_are_the_references():
    from portbench.entries.batch import Entry

    here = pathlib.Path(traffic_gen.__file__).parent
    config = json.loads((here / "configs" / "corpus22k.json").read_text())
    cell = json.loads((here / "traffic" / "corpus22k.b64.json").read_text())
    assert config["sample_rate"] == SR and cell["batch"] == 64 and cell["utterance_s"] == 10.0
    traffic = dict(cell, batch=B, gain_bank=2, kept_calls=1)
    entry = Entry(config, traffic, 7, torch.device("cpu"))
    g, cfg = plain.Geometry(SR), port.SpeedyConfig(SR)
    n = 220500
    assert (cfg.window_size, cfg.frame_step_int) == (g.window, g.step) == (330, 220)
    assert g.hop == 220
    assert analysis_fft.fft_plan(330).route != "direct"
    assert 11 in analysis_fft.fft_plan(330).radices
    assert entry.shapes["W"] == 330 and entry.shapes["T"] == g.frames(n) == 1001
    assert (entry.shapes["min_period"], entry.shapes["max_period"]) == (55, 339)
    assert (g.min_period, g.max_period) == (55, 339)
    assert wsola_fast.pitch_grid_stride(cfg) == g.grid_stride == 768
    assert entry.shapes["n_grid"] == -(-(n + 2 * 339) // 768) == 288
    # SpeedupEngine's capacity: the reference's, cut to 1.33 L / rate.
    cap = min(g.capacity(n, 1.0), int(math.ceil(1.33 * n / 3.5 / g.hop) + 2) * g.hop)
    assert entry.capacity == cap == 84260


def _reporting(frames):
    """Kernel 1's C entry point, faked: energy and lsd set to 0, BLOCKS
    blocks a row and the body's frames parameter `frames` reported."""

    def entry(x, gain, hamming, table, energy, lsd, b, n, t, w, step, code, eps, launched,
              stream):
        ctypes.memset(energy, 0, b * t * 4)
        ctypes.memset(lsd, 0, b * t * 4)
        report = (ctypes.c_int * 2).from_address(launched)
        report[0], report[1] = BLOCKS, frames
        return 0

    return entry


@pytest.fixture
def fake_kernel_1(monkeypatch):
    """kernels.analysis_energy_lsd takes its launch path on CPU tensors;
    the test sets the fake entry point. Counts are zero before and after."""
    monkeypatch.setattr(kernels, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(kernels, "_current_device", lambda: None)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: 0)
    trace.reset()
    yield lambda entry: monkeypatch.setattr(
        _build, "load", lambda: {"analysis_energy_lsd": entry})
    trace.reset()


def _analysis(sr, n=L):
    xs, gain = _inputs(sr, n)
    cfg = port.SpeedyConfig(sr)
    return batch.batched_analysis(xs, cfg, cfg.num_frames(n, integer_step=True), gain)


# The frames parameter each cell's launcher picks on the card: steps of one
# at W = 330 (corpus22k.b64), of two at W = 240 on a grid of many waves
# (corpus16k.*), 16 frames a thread in the direct body (corpus44k.b2048).
@pytest.mark.parametrize("sr,plan,frames", [
    (22050, "analysis_energy_lsd:fft:330x1", 1),
    (16000, "analysis_energy_lsd:fft:240x2", 2),
    (44100, "analysis_energy_lsd:direct:661x16", 16),
])
def test_plans_count_the_plan_as_launched(fake_kernel_1, sr, plan, frames):
    fake_kernel_1(_reporting(frames))
    for n in (1, 2):
        _analysis(sr)
        assert trace.PLANS == {plan: n}
        assert sum(trace.BODIES.values()) == trace.LAUNCHES["analysis_energy_lsd"] == n


def test_reset_empties_plans(fake_kernel_1):
    fake_kernel_1(_reporting(1))
    _analysis(SR)
    _analysis(16000)
    assert trace.PLANS == {"analysis_energy_lsd:fft:330x1": 1,
                           "analysis_energy_lsd:fft:240x1": 1}
    trace.reset()
    assert trace.PLANS == {}


def test_a_failed_launch_counts_no_plan(fake_kernel_1, monkeypatch):
    fake_kernel_1(lambda *a: 98)
    monkeypatch.setattr(_build, "_library", lambda: type("Lib", (), {
        "speedy_cuda_error_string": staticmethod(lambda err: b"fake")})())
    for sr in (SR, 44100):
        with pytest.raises(RuntimeError, match="analysis_energy_lsd: CUDA error 98"):
            _analysis(sr)
    assert trace.PLANS == {} and trace.BODIES == {}


def test_the_plain_path_counts_no_plan():
    trace.reset()
    xs, gain = _inputs()
    port.batched_nonlinear_speedup(xs, torch.full((B,), L, dtype=torch.int32),
                                   port.SpeedyConfig(SR), 3.5, NL, FB, gain=gain,
                                   capacity_factor=CAP)
    assert trace.PLANS == {} and trace.BODIES == {}
    assert not any(trace.LAUNCHES.values())
