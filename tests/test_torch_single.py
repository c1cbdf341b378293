"""The PyTorch port's single-utterance grid pipeline (pipeline.py and
wsola_fast.time_scale_grid) against the JAX package's on the CPU, where
every kernel wrapper takes its plain version, on the same seeded inputs
(the synthetic families of bench.py, 1-2 s each).

Tolerances, from the reference's own gates:
  - valid lengths equal, so achieved rates equal (within 1e-3);
  - tension within 2e-5 except at 40 dB mask-edge frames
    (tests/test_chunked.py:38); speeds within 1e-5 up to the first such
    frame (the law's float32 steps, tests/test_torch_frontend.py);
  - fed the JAX engine's own speeds and pitch grid, the port's engine
    output within max|d| < 2e-3 and mean < 1e-5 (__graft_entry__.py:178);
  - with each package's own pitch grid, outputs agree up to float64 pitch
    ties (torch_port_util.assert_singles_agree);
  - bounded (kernel 3) and unbounded (kernel 4) synthesis within 1e-6;
  - the pass-through at 1.0x within 1 LSB and the ±14 ms length contract
    (tests/test_wsola.py:122-136).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speedy_tpu import pipeline as jpipeline
from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.ops import wsola_fast as jwf

from speedy_tpu_torch import (
    SpeedyConfig,
    linear_time_scale,
    nonlinear_speedup,
    time_scale_grid,
    trace,
)

from torch_port_util import (
    assert_singles_agree,
    assert_tension_gate,
    single_pitch_grids,
    speech_families,
)


def _speeds(cfg, L):
    """Per-frame speeds in [2.5, 4.5], below the bound 6.6."""
    T = cfg.num_frames(L, integer_step=True)
    return (3.5 + np.sin(np.arange(T) * 0.1)).astype(np.float32)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("sr", [16000, 22050])
def test_time_scale_grid_matches_jax(sr, bounded):
    cfg = SpeedyConfig(sr)
    L = int(1.5 * sr)
    xs = speech_families(L, sr, 4, seed=11)
    speeds = _speeds(cfg, L)
    bound = 6.6 if bounded else None
    ys_j, ys_t, d_fed = [], [], []
    trace.reset()
    for x in xs:
        rj = jwf.time_scale_grid(jnp.asarray(x), jnp.asarray(speeds), JConfig(sr),
                                 min_speed_bound=1.0, max_speed_bound=bound)
        rt = time_scale_grid(x, speeds, cfg, min_speed_bound=1.0,
                             max_speed_bound=bound, device="cpu")
        n = int(rj.valid_length)
        assert int(rt.valid_length) == n
        y_j, y_t = np.asarray(rj.output), rt.output.numpy()
        assert y_t.shape == y_j.shape and np.all(y_t[n:] == 0.0)
        ys_j.append(y_j[:n])
        ys_t.append(y_t[:n])
        # Fed the JAX engine's own pitch grid, the port's engine reproduces it.
        grid_j, _ = single_pitch_grids(x, speeds, cfg, 1.0, bound)
        fed = time_scale_grid(x, speeds, cfg, min_speed_bound=1.0, max_speed_bound=bound,
                              device="cpu", period_grid=torch.as_tensor(grid_j[0]))
        d_fed.append(np.abs(fed.output.numpy() - y_j))
    # One gate over the four utterances, as over a batch of them.
    d = np.concatenate(d_fed)
    assert d.max() < 2e-3 and d.mean() < 1e-5, (d.max(), d.mean())
    assert trace.LAUNCHES == dict.fromkeys(trace.LAUNCHES, 0)
    assert_singles_agree(xs, ys_j, ys_t, [speeds] * 4, [speeds] * 4, cfg,
                         [1.0] * 4, bound)


@pytest.mark.parametrize("sr", [16000, 44100])
def test_bounded_route_matches_per_row_route(sr):
    """Kernel 3's route (a speed ceiling) and kernel 4's (none) synthesize
    the same chunk positions: their outputs agree within 1e-6
    (tests/test_wsola.py:166-192 holds the JAX package's two routes
    equal)."""
    cfg = SpeedyConfig(sr)
    L = sr
    x = speech_families(L, sr, 1, seed=4)[0]
    speeds = _speeds(cfg, L)
    r1 = time_scale_grid(x, speeds, cfg, min_speed_bound=1.0, device="cpu")
    r2 = time_scale_grid(x, speeds, cfg, min_speed_bound=1.0, max_speed_bound=6.6,
                         device="cpu")
    assert int(r1.valid_length) == int(r2.valid_length) > 0
    assert float((r1.output - r2.output).abs().max()) < 1e-6


def _as_int16(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("rate", [2.0, 3.5, 0.7])
def test_nonlinear_speedup_matches_jax(rate, dtype):
    """On the three speech-like families (the noise-burst family's steep
    waveform turns float32 rounding of the chunk positions, summed in
    another order by XLA, into mean differences near the 1e-5 gate; the
    engine test above holds it in a batch of all four)."""
    sr = 16000
    cfg = SpeedyConfig(sr)
    L = 2 * sr
    xs = speech_families(L, sr, 4, seed=11)[[0, 1, 3]]
    inputs = xs if dtype == "float32" else [_as_int16(x) for x in xs]
    T = cfg.num_frames(L, integer_step=True)
    ys_j, ys_t, sp_j, sp_t, bounds, xf = [], [], [], [], [], []
    for x in inputs:
        rj = jpipeline.nonlinear_speedup(x, JConfig(sr), rate, 1.0, 0.1, engine="grid")
        rt = nonlinear_speedup(x, cfg, rate, 1.0, 0.1, engine="grid", device="cpu")
        assert rt.output.dtype == rj.output.dtype == np.dtype(dtype)
        assert len(rt.output) == len(rj.output)
        assert abs(rt.achieved_rate - rj.achieved_rate) < 1e-3
        x_f = x.astype(np.float32) / (32768.0 if dtype == "int16" else 1.0)
        assert_tension_gate(x_f, cfg, T, rj.tension, rt.tension)
        out = np.flatnonzero(np.abs(rt.tension - rj.tension) > 2e-5)
        upto = out[0] if out.size else T
        np.testing.assert_allclose(rt.speeds[:upto], rj.speeds[:upto], rtol=0, atol=1e-5)
        if dtype == "int16":
            # int16 input is x / 2^15 in float32, and the output is that
            # run's rounded: compare the runs before rounding (a float
            # difference far under 1 LSB can still round apart).
            rj = jpipeline.nonlinear_speedup(x_f, JConfig(sr), rate, 1.0, 0.1,
                                             engine="grid")
            rf = nonlinear_speedup(x_f, cfg, rate, 1.0, 0.1, engine="grid", device="cpu")
            np.testing.assert_array_equal(rt.output, _as_int16(rf.output))
            rt = rf
        ys_j.append(rj.output)
        ys_t.append(rt.output)
        sp_j.append(rj.speeds)
        sp_t.append(rt.speeds)
        bounds.append(max(0.01, float(rj.speeds.min()) * 0.999))
        xf.append(x_f)
    assert_singles_agree(np.stack(xf), ys_j, ys_t, sp_j, sp_t, cfg, bounds)


def test_linear_passthrough_and_length_contract():
    """tests/test_wsola.py:122-136 for the port's grid engine: at 1.0x the
    output is the input within 1 LSB; at 1.1x and 6.3x the length is
    within ±14 ms (+1.5%) of input/speed."""
    sr = 22050
    cfg = SpeedyConfig(sr)
    i = np.arange(int(sr * 2.0))
    sinusoid = (32000 * np.sin(i * 2 * np.pi * 237.0 / sr)).astype(np.int16)
    r = linear_time_scale(sinusoid[: int(sr * 0.3)], cfg, 1.0, engine="grid", device="cpu")
    assert len(r.output) == int(sr * 0.3)
    d = np.abs(r.output.astype(np.int32) - sinusoid[: int(sr * 0.3)].astype(np.int32))
    assert d.max() <= 1
    for speed in (1.1, 6.3):
        r = linear_time_scale(sinusoid, cfg, speed, engine="grid", device="cpu")
        expected = len(sinusoid) / speed
        assert abs(len(r.output) - expected) < 0.014 * sr + 0.015 * expected
        rj = jpipeline.linear_time_scale(sinusoid, JConfig(sr), speed, engine="grid")
        assert len(r.output) == len(rj.output)
        assert r.tension.shape == (0,) and r.speeds.tolist() == [np.float32(speed)]


@pytest.mark.parametrize("L", [100, 400, 1000])
def test_clips_without_tension_run_at_the_global_speed(L):
    """Shorter than the tension lookahead: no tension frame, so the clip
    runs at the global speed, as the linear path would. (For 2 <= T <= 8
    analysis frames, L = 400 and 1000 here, the JAX package's analyze
    raises; see tests/test_torch_analysis.py.)"""
    cfg = SpeedyConfig(16000)
    x = speech_families(L, 16000, 1, seed=6)[0]
    rn = nonlinear_speedup(x, cfg, 2.0, engine="grid", device="cpu")
    rl = linear_time_scale(x, cfg, 2.0, engine="grid", device="cpu")
    np.testing.assert_array_equal(rn.output, rl.output)
    assert rn.tension.shape == (0,) and rn.speeds.tolist() == [2.0]
    rj = jpipeline.linear_time_scale(x, JConfig(16000), 2.0, engine="grid")
    assert len(rn.output) == len(rj.output)


@pytest.mark.parametrize("engine", ["scan", "stream", "device-stream"])
def test_unported_engines_raise(engine):
    x = np.zeros(4000, np.float32)
    cfg = SpeedyConfig(16000)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        nonlinear_speedup(x, cfg, 2.0, engine=engine, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        linear_time_scale(x, cfg, 2.0, engine=engine, device="cpu")
    with pytest.raises(NotImplementedError):
        nonlinear_speedup(x, cfg, 2.0, device="cpu")  # the JAX default, "scan"
    with pytest.raises(ValueError, match="unknown engine"):
        nonlinear_speedup(x, cfg, 2.0, engine="fast", device="cpu")
