"""The PyTorch port's batched_nonlinear_speedup against the JAX package's,
end to end on the CPU (where every kernel wrapper takes its plain
version): equal valid lengths, tension within 2e-5 but at 40 dB mask
edges, and outputs within the dryrun tolerance (max|d| < 2e-3, mean
< 1e-5) wherever the two pitch grids agree, every disagreement being a
proven float64 SSD tie."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.parallel import batch as jbatch

from speedy_tpu_torch import SpeedupEngine, SpeedyConfig, batched_nonlinear_speedup
from speedy_tpu_torch.ops import kernels
from speedy_tpu_torch.ops.wsola_fast import (
    grid_positions,
    pitch_grid_stride,
    plan_grid,
    wsola_grid_batch,
)
from speedy_tpu_torch.parallel.batch import _plan_max_speed

import testutil
from torch_port_util import (
    assert_outputs_agree_up_to_ties,
    cpu_tables,
    jax_pitch_grid,
    speech_families,
)

CASES = {
    # name: (sample rate, B, L, rate, capacity_factor, gain, lengths cut,
    #        capacity)
    "16k-3.5x-gain-cap1.33": (16000, 4, 32000, 3.5, 1.33, True, (0, 2500, 0, 0), None),
    "16k-0.7x": (16000, 2, 12000, 0.7, None, False, (0, 1700), None),
    "22k-3.0x": (22050, 2, 44100, 3.0, None, False, (0, 900), None),
    "44k-3.5x-gain-cap1.33": (44100, 2, 441000, 3.5, 1.33, True, (0, 20000), None),
    "clip-shorter-than-lookahead": (16000, 2, 1400, 2.0, None, True, (0, 500), 960),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(name):
    sr, B, L, rate, cap_factor, use_gain, cuts, capacity = CASES[name]
    cfg = SpeedyConfig(sr)
    xs = speech_families(L, sr, B, seed=1)
    lengths = (L - np.asarray(cuts)).astype(np.int32)
    gain = (
        np.random.default_rng(2).uniform(0.5, 1.0, B).astype(np.float32)
        if use_gain else None
    )
    kernels.reset_launches()

    rj = jbatch.batched_nonlinear_speedup(
        jnp.asarray(xs), jnp.asarray(lengths), JConfig(sr), rate, 1.0, 0.1,
        gain=None if gain is None else jnp.asarray(gain),
        capacity_factor=cap_factor, capacity=capacity,
    )
    tg = None if gain is None else torch.as_tensor(gain)
    rt = batched_nonlinear_speedup(
        torch.as_tensor(xs), torch.as_tensor(lengths), cfg, rate, 1.0, 0.1,
        gain=tg, capacity_factor=cap_factor, capacity=capacity,
    )
    y_j, y_t = np.asarray(rj.output), rt.output.numpy()
    assert y_t.shape == y_j.shape
    np.testing.assert_array_equal(rt.valid_length.numpy(), np.asarray(rj.valid_length))
    assert np.all(np.isfinite(y_t))

    T = cfg.num_frames(L, integer_step=True)
    t_j, t_t = np.asarray(rj.tension), rt.tension.numpy()
    assert t_t.shape == t_j.shape
    for b in range(B if t_j.shape[1] else 0):
        testutil.assert_tension_outliers_are_mask_edges(
            xs[b], cfg, T, np.abs(t_t[b] - t_j[b]), outlier_thresh=2e-5
        )

    # The two pitch grids: the JAX package's off-TPU search and the port's.
    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    hop = plan_grid(cfg, L, 1.0)[0]
    G = pitch_grid_stride(cfg, hop)
    n_grid = -(-(L + 2 * maxp) // G)
    grid_j = jax_pitch_grid(xs, gain, maxp, minp, maxp, G, n_grid)
    tab = cpu_tables(cfg)
    grid_t = kernels.pitch_ssd(
        torch.as_tensor(xs),
        torch.ones(B) if gain is None else tg,
        maxp, minp, maxp, G, n_grid,
        tuple(tab[k] for k in ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band")),
    ).numpy()
    assert_outputs_agree_up_to_ties(
        y_j, y_t, np.asarray(rj.valid_length), np.asarray(rj.speeds), xs,
        grid_j, grid_t, cfg, hop,
    )
    # Fed the JAX package's pitch grid, the port reproduces its output.
    fed = batched_nonlinear_speedup(
        torch.as_tensor(xs), torch.as_tensor(lengths), cfg, rate, 1.0, 0.1,
        gain=tg, capacity_factor=cap_factor, capacity=capacity,
        period_grid=torch.as_tensor(grid_j),
    ).output.numpy()
    d = np.abs(fed - y_j)
    assert d.max() < 2e-3 and d.mean() < 1e-5, (d.max(), d.mean())
    # CPU tensors never reach a kernel.
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_engine_matches_function_and_reference_flag():
    """SpeedupEngine.forward is batched_nonlinear_speedup with the engine's
    buffers; reference=True (the plain versions, on any device) gives the
    same result as the CPU wrappers."""
    cfg = SpeedyConfig(16000)
    B, L = 2, 20000
    xs = torch.as_tensor(speech_families(L, 16000, B, seed=4))
    lengths = torch.tensor([L, L - 3000])
    gain = torch.tensor([0.8, 0.6])
    eng = SpeedupEngine(cfg, 3.5, capacity_factor=1.33)
    r1 = eng(xs, lengths, gain)
    r2 = batched_nonlinear_speedup(
        xs, lengths, cfg, 3.5, 1.0, 0.1, gain=gain, capacity_factor=1.33,
        tables=cpu_tables(cfg),
    )
    r3 = batched_nonlinear_speedup(
        xs, lengths, cfg, 3.5, 1.0, 0.1, gain=gain, capacity_factor=1.33,
        tables=eng.tables(), reference=True,
    )
    for r in (r2, r3):
        assert torch.equal(r1.output, r.output)
        assert torch.equal(r1.valid_length, r.valid_length)
        assert torch.equal(r1.tension, r.tension)
    assert int(r1.valid_length.max()) < r1.output.shape[1]


def test_grid_positions_move_only_where_a_rounding_tips():
    """The phase snap makes each chunk's source position c_0 + k*hop -
    snap*P independent of its nominal position c_k: nudging the speeds
    moves output samples by more than the 2e-3 gate only in the two slots
    of a chunk whose pitch cell or snap count rounds differently (the
    attribution chip_smoke.py applies to the plain path against the kernel
    path)."""
    cfg = SpeedyConfig(16000)
    B, L, rate = 4, 48000, 3.5
    xs = torch.as_tensor(speech_families(L, 16000, B, seed=2))
    lengths = torch.full((B,), L, dtype=torch.int32)
    eng = SpeedupEngine(cfg, rate, capacity_factor=1.33)
    res = eng(xs, lengths)
    hop, G = 160, pitch_grid_stride(cfg)
    capacity = res.output.shape[1]
    K = capacity // hop + 1
    tables = eng.tables()
    corr = tuple(tables[k] for k in ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band"))
    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    grid = kernels.pitch_ssd(
        xs, torch.ones(B), maxp, minp, maxp, G, -(-(L + 2 * maxp) // G), corr
    )
    plan = _plan_max_speed(rate, 1.0)
    rng = np.random.default_rng(1)
    noise = torch.as_tensor(rng.standard_normal(res.speeds.shape).astype(np.float32))
    speeds = res.speeds * (1.0 + 1e-4 * noise)
    out = wsola_grid_batch(
        xs, lengths, speeds, minp, maxp, cfg.frame_step_int, hop, capacity, K,
        tables["cola"], corr, max_speed_plan=plan, period_grid=grid,
    )
    pk, pp = (
        grid_positions(lengths, s, grid, cfg.frame_step_int, hop, G, capacity, K, plan)
        for s in (res.speeds, speeds)
    )
    # The nudge may move an utterance's end by a sample: compare up to the
    # shorter of the two.
    upto = torch.minimum(out.valid_length, res.valid_length)[:, None]
    live = torch.arange(K)[None, :] * hop < upto
    tipped = live & ((pk.cell != pp.cell) | (pk.snap != pp.snap))
    assert 0 < int(tipped.sum()) < 0.01 * int(live.sum())
    # Elsewhere the positions agree to float32 rounding of c_k + o_k.
    steady = live & ~tipped
    assert float((pk.a - pp.a).abs()[steady].max()) < 0.01
    touched = tipped.clone()
    touched[:, 1:] |= tipped[:, :-1]
    near = touched.repeat_interleave(hop, dim=1)[:, :capacity]
    d = torch.where(
        torch.arange(capacity)[None, :] < upto, (out.output - res.output).abs(), 0.0
    )
    assert float(d[~near].max()) < 2e-3
    assert float(d.max()) > 2e-3
