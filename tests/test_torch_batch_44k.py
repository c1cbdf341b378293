"""The batch engine at 44.1 kHz on the CPU: batched_nonlinear_speedup
against the benchmark's plain float32 reference (portbench/reference/
plain.py, which imports nothing of the program), the sizes the rate
gives, and kernel 1's count and span by body (trace.BODIES, the
"speedy:analysis_kernel:<body>" span).

There is no card here, so the body tests fake kernel 1's launch as
tests/test_torch_launch.py fakes one: _on_cuda says yes, the bound table
holds a fake entry point that zeroes energy and lsd, and the device and
stream lookups are stubs. The plan, the launch path and the counting are
the program's own."""

import ctypes
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import speedy_tpu_torch as port
from portbench import judge, traffic_gen
from portbench.reference import plain
from speedy_tpu_torch import trace
from speedy_tpu_torch.ops import _build, kernels, wsola_fast
from speedy_tpu_torch.parallel import batch

SR = 44100
B, L = 4, 2 * SR
NL, FB, CAP = 1.0, 0.1, 1.33
DIRECT, FFT = "analysis_energy_lsd:direct", "analysis_energy_lsd:fft"


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
    tally = judge.Tally()
    tally.add(res.tension, ref.tension, res.speeds, ref.speeds, res.output, ref.output,
              res.valid_length, ref.valid)
    assert float(torch.cat(tally.tension).max()) < 2e-5
    assert float(torch.cat(tally.speeds).max()) < 2e-5
    assert tally.numbers()["audio_err_max"] < 1e-9


def test_the_rates_sizes_are_the_references():
    from portbench.entries.batch import Entry

    config = json.loads(
        (pathlib.Path(traffic_gen.__file__).parent / "configs" / "corpus44k.json").read_text())
    traffic = {"batch": B, "utterance_s": 10.0, "families": [0, 1, 2, 3], "gain": [0.5, 1.0],
               "gain_bank": 2, "kept_calls": 1}
    entry = Entry(config, traffic, 7, torch.device("cpu"))
    g, cfg = plain.Geometry(SR), port.SpeedyConfig(SR)
    assert (cfg.window_size, cfg.frame_step_int) == (g.window, g.step) == (661, 441)
    assert entry.shapes["W"] == 661 and entry.shapes["T"] == g.frames(441000) == 999
    assert (entry.shapes["min_period"], entry.shapes["max_period"]) == (110, 678)
    assert (g.min_period, g.max_period) == (110, 678)
    assert wsola_fast.pitch_grid_stride(cfg) == g.grid_stride == 1408
    assert entry.shapes["n_grid"] == -(-(441000 + 2 * 678) // 1408)


def _zero_outputs(x, gain, hamming, table, energy, lsd, b, n, t, w, step, code, eps,
                  stream):
    """Kernel 1's C entry point, faked: energy and lsd set to 0."""
    ctypes.memset(energy, 0, b * t * 4)
    ctypes.memset(lsd, 0, b * t * 4)
    return 0


@pytest.fixture
def fake_kernel_1(monkeypatch):
    """kernels.analysis_energy_lsd takes its launch path on CPU tensors,
    with a fake entry point; counts are zero before and after."""
    monkeypatch.setattr(kernels, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(_build, "load", lambda: {"analysis_energy_lsd": _zero_outputs})
    monkeypatch.setattr(kernels, "_current_device", lambda: None)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: 0)
    trace.reset()
    yield
    trace.reset()


def _analysis(sr, n=L):
    xs, gain = _inputs(sr, n)
    cfg = port.SpeedyConfig(sr)
    return batch.batched_analysis(xs, cfg, cfg.num_frames(n, integer_step=True), gain)


@pytest.mark.parametrize("sr,body", [(44100, DIRECT), (16000, FFT)])
def test_bodies_count_the_body_the_plan_picked(fake_kernel_1, sr, body):
    for n in (1, 2):
        _analysis(sr)
        assert trace.BODIES == {body: n}
        assert trace.LAUNCHES["analysis_energy_lsd"] == n
    trace.reset()
    assert trace.BODIES == {}
    _analysis(sr)
    trace.reset()
    assert trace.BODIES == {} and not any(trace.LAUNCHES.values())


def test_a_failed_launch_counts_no_body(fake_kernel_1, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda: {"analysis_energy_lsd": lambda *a: 98})
    monkeypatch.setattr(_build, "_library", lambda: type("Lib", (), {
        "speedy_cuda_error_string": staticmethod(lambda err: b"fake")})())
    with pytest.raises(RuntimeError, match="analysis_energy_lsd: CUDA error 98"):
        _analysis(SR)
    assert trace.BODIES == {}


def test_the_plain_path_counts_no_body():
    trace.reset()
    xs, gain = _inputs()
    port.batched_nonlinear_speedup(xs, torch.full((B,), L, dtype=torch.int32),
                                   port.SpeedyConfig(SR), 3.5, NL, FB, gain=gain,
                                   capacity_factor=CAP)
    assert trace.BODIES == {}
    assert not any(trace.LAUNCHES.values())


def _ranges(prof, tmp_path):
    """(start, end, name) of every speedy: range, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(trace.PREFIX):])
                  for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith(trace.PREFIX))


@pytest.mark.parametrize("sr,body", [(44100, "direct"), (16000, "fft")])
def test_the_body_span_nests_in_the_analysis_span(fake_kernel_1, tmp_path, sr, body):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _analysis(sr)
    ranges = _ranges(prof, tmp_path)
    names = [r[2] for r in ranges]
    assert names.count("analysis_kernel:" + body) == 1
    assert not any(n.startswith("analysis_kernel:") and n != "analysis_kernel:" + body
                   for n in names)
    (a0, a1, _), = [r for r in ranges if r[2] == "analysis"]
    (k0, k1, _), = [r for r in ranges if r[2] == "analysis_kernel:" + body]
    assert a0 <= k0 and k1 <= a1


def test_no_profiler_no_body_span(fake_kernel_1, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _analysis(SR)
    _analysis(16000)
    assert trace.BODIES == {DIRECT: 1, FFT: 1}
