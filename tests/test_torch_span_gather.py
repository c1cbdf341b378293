"""The PyTorch port's block-span gathers (kernels.gather_rows_block, kernel 5,
and kernels.gather_rows_block_v2, kernel 8) and the span synthesis route
(wsola_fast._synth_spans) against the JAX package on
the CPU, where every wrapper takes its plain version, on seeded inputs.

The JAX results are compared only where JAX defines them: rows below
n_valid, starts in [0, L - width], and every block's starts spread by at
most w_span - width (the span contract). There the tolerance is none: the
rows are equal. Past n_valid the port's rows are zeros; the JAX kernel
leaves them unspecified, so they are compared with nothing.

Kernel 8 is the schedule of experiments/gather_v2.py, which cannot be
imported (it times B=128 x 10 s at module level); that experiment's own
oracle is kernel 5 (gather_v2.py:146-150), and so it is here.

The span route is held to JAX's bounded time_scale_grid (its route off the
TPU, speedy_tpu/ops/wsola_fast.py:606-612), fed the JAX engine's own pitch
grid: max|d| < 2e-3 and mean < 1e-5 (__graft_entry__.py:178-179) with
equal valid lengths; and to the port's own kernel-3 route on the same
chunk positions within 1e-6 (PERF.md §2's gate between the bounded and
unbounded routes).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import speedy_tpu.ops.pallas_kernels as pk
from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.ops import wsola as jwsola
from speedy_tpu.ops import wsola_fast as jwf
from speedy_tpu.parallel import batch as jbatch

from speedy_tpu_torch import SpeedyConfig, trace
from speedy_tpu_torch.ops import kernels, wsola_fast

from torch_port_util import single_pitch_grids, speech_families


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Run pk's pallas_call in interpret mode (the fixture of
    tests/test_pallas_kernels.py, copied)."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk.pl, "pallas_call", interp)
    # The jitted wrapper closes over pl.pallas_call at trace time; clear
    # its cache so the patched version is traced.
    pk.gather_rows_block_pallas.clear_cache()
    yield
    pk.gather_rows_block_pallas.clear_cache()


def _case(width, B=3, K=70, L=40000):
    """tests/test_pallas_kernels.py:41-49's monotone case: x [B, L], starts
    stepping 0..900 samples, in range; R=32 and the w_span that covers 31
    such steps and a row."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, L)).astype(np.float32)
    steps = rng.integers(0, 900, size=(B, K))
    starts = np.minimum(np.cumsum(steps, axis=1), L - width - 1).astype(np.int32)
    R = 32
    w_span = -(-((R - 1) * 900 + width + 32) // 1024) * 1024
    return x, starts, R, w_span


N_VALID = {"all": None, "partial": (70, 33, 5), "one": (1, 1, 1)}


@functools.lru_cache(maxsize=None)
def _jax_block_rows(width, n_valid):
    x, starts, R, w_span = _case(width)
    nv = None if n_valid is None else jnp.asarray(np.asarray(n_valid, np.int32))
    return np.asarray(
        pk.gather_rows_block_pallas(jnp.asarray(x), jnp.asarray(starts), width, R, w_span, nv)
    )


def _check(rows, want, n_valid):
    K = rows.shape[1]
    for b, n in enumerate([K] * rows.shape[0] if n_valid is None else n_valid):
        np.testing.assert_array_equal(rows[b, :n], want[b, :n])
        assert np.all(rows[b, n:] == 0.0)


@pytest.mark.parametrize("n_valid", list(N_VALID))
@pytest.mark.parametrize("width", [321, 443])
@pytest.mark.parametrize("kernel", ["gather_rows_block", "gather_rows_block_v2"])
def test_block_gathers_match_jax(interpret_pallas, kernel, width, n_valid):
    """Kernels 5 and 8 against gather_rows_block_pallas in interpret mode
    (the cases of tests/test_pallas_kernels.py:71-91)."""
    x, starts, R, w_span = _case(width)
    nv = N_VALID[n_valid]
    nv_t = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    trace.reset()
    rows = getattr(kernels, kernel)(
        torch.as_tensor(x), torch.as_tensor(starts), width, R, w_span, nv_t
    ).numpy()
    assert not any(trace.LAUNCHES.values())  # CPU tensors: the plain version
    assert rows.shape == (3, 70, width) and rows.dtype == np.float32
    _check(rows, _jax_block_rows(width, nv), nv)


@pytest.mark.parametrize("n_valid", [None, (50, 80, 101)])
def test_gather_rows_spans_matches_jax(n_valid):
    """kernels.gather_rows_block, the span route's gather, against the JAX
    package's wsola_fast._gather_rows_spans on the CPU, its XLA route (the
    case of tests/test_wsola.py:139-163)."""
    rng = np.random.default_rng(7)
    B, K, width, L = 3, 101, 321, 50000
    x = rng.standard_normal((B, L)).astype(np.float32)
    steps = rng.integers(0, 900, size=(B, K))
    starts = np.minimum(np.cumsum(steps, axis=1), L - width - 1).astype(np.int32)
    R = 32
    w_span = -(-((R - 1) * 900 + width + 32) // 1024) * 1024
    nv_j = None if n_valid is None else jnp.asarray(np.asarray(n_valid, np.int32))
    want = np.asarray(
        jwf._gather_rows_spans(jnp.asarray(x), jnp.asarray(starts), width, R, w_span, nv_j)
    )
    nv_t = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32)
    got = kernels.gather_rows_block(
        torch.as_tensor(x), torch.as_tensor(starts), width, R, w_span, nv_t
    ).numpy()
    _check(got, want, n_valid)


@pytest.mark.parametrize("sr, w_span", [(16000, 133120), (22050, 183296), (44100, 366592)])
def test_span_width_is_the_engine_plan(sr, w_span):
    """span_width at the engine's plan (R=128, the ceiling
    _plan_max_speed(3.5, 1.0) = 6.5) against speedy_tpu/ops/
    wsola_fast.py:547-553, evaluated with the JAX package's own plan_grid,
    wsola.plan and _plan_max_speed."""
    jcfg = JConfig(sr)
    L = 10 * sr
    hop, _, _ = jwf.plan_grid(jcfg, L, 1.0)
    _, maxp, _, _ = jwsola.plan(jcfg, L, 1.0)
    ceiling = jbatch._plan_max_speed(3.5, 1.0)
    width = 2 * hop + 1
    need = (128 - 1) * int(np.ceil(hop * ceiling)) + maxp + width + 32
    assert -(-need // 1024) * 1024 == w_span
    assert wsola_fast.SPAN_ROWS == 128
    assert wsola_fast.span_width(128, hop, ceiling, maxp, width) == w_span


def _speeds(cfg, L):
    """Per-frame speeds in [2.5, 4.5], below the ceiling 6.6."""
    T = cfg.num_frames(L, integer_step=True)
    return (3.5 + np.sin(np.arange(T) * 0.1)).astype(np.float32)


def _span_route(xs, a_i, a_f, pos, hop, cap, cfg, ceiling):
    return wsola_fast._synth_spans(
        xs, a_i, a_f, torch.as_tensor(wsola_fast._cola_hann(2 * hop)), None, pos.valid,
        hop, cap, cfg.wsola_max_period, ceiling,
    )[0]


def grid_chunk_positions(x, speeds, cfg, min_speed_bound, max_speed_bound, period_grid=None):
    """Stages 1-3 of the port's grid engine for one utterance x [L], as
    time_scale_grid runs them on the CPU: (xs [1, L], a_i [1, K] int32,
    a_f [1, K], GridPositions, hop, capacity). period_grid [1, n_grid]
    (optional) replaces the plain pitch search."""
    from speedy_tpu_torch.ops.kernels import pitch_ssd_reference
    from speedy_tpu_torch.ops.wsola_fast import (
        grid_positions, pitch_corr_matrices, pitch_grid_stride, plan_grid,
    )

    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    xs = torch.as_tensor(np.asarray(x, np.float32))[None]
    L = xs.shape[1]
    hop, cap, K = plan_grid(cfg, L, min_speed_bound)
    G = pitch_grid_stride(cfg, hop)
    if period_grid is None:
        n_grid = -(-(L + 2 * maxp) // G)
        corr = tuple(torch.as_tensor(m) for m in pitch_corr_matrices(cfg))
        period_grid = pitch_ssd_reference(xs, torch.ones(1), maxp, minp, maxp, G, n_grid, corr)
    pos = grid_positions(
        torch.tensor([L], dtype=torch.int32),
        torch.as_tensor(np.asarray(speeds, np.float32)).reshape(1, -1),
        torch.as_tensor(period_grid), cfg.frame_step_int, hop, G, cap, K, max_speed_bound,
    )
    a_i = torch.floor(pos.a).to(torch.int32)
    return xs, a_i, pos.a - a_i.to(torch.float32), pos, hop, cap


@pytest.mark.parametrize("sr", [16000, 22050])
def test_span_route_matches_jax_bounded_engine(sr):
    """The span route fed each utterance's chunk positions (from the JAX
    engine's own pitch grid) against JAX's time_scale_grid with
    max_speed_bound, which synthesizes through its block-span gather off
    the TPU; one gate over four utterances, as over a batch."""
    cfg = SpeedyConfig(sr)
    L = int(1.5 * sr)
    speeds = _speeds(cfg, L)
    d = []
    trace.reset()
    for x in speech_families(L, sr, 4, seed=11):
        rj = jwf.time_scale_grid(jnp.asarray(x), jnp.asarray(speeds), JConfig(sr),
                                 min_speed_bound=1.0, max_speed_bound=6.6)
        grid_j, _ = single_pitch_grids(x, speeds, cfg, 1.0, 6.6)
        xs, a_i, a_f, pos, hop, cap = grid_chunk_positions(
            x, speeds, cfg, 1.0, 6.6, torch.as_tensor(grid_j))
        y = _span_route(xs, a_i, a_f, pos, hop, cap, cfg, 6.6).numpy()
        y_j = np.asarray(rj.output)
        assert int(pos.valid[0]) == int(rj.valid_length)
        assert y.shape == y_j.shape
        d.append(np.abs(y - y_j))
    d = np.concatenate(d)
    assert d.max() < 2e-3 and d.mean() < 1e-5, (d.max(), d.mean())
    assert not any(trace.LAUNCHES.values())


@pytest.mark.parametrize("sr", [16000, 44100])
def test_span_route_matches_fused_route(sr):
    """The span route and kernel 3's plain version on the same chunk
    positions, and time_scale_grid with the ceiling (kernel 3's route),
    within 1e-6 with equal valid lengths."""
    cfg = SpeedyConfig(sr)
    L = sr
    x = speech_families(L, sr, 1, seed=4)[0]
    speeds = _speeds(cfg, L)
    xs, a_i, a_f, pos, hop, cap = grid_chunk_positions(x, speeds, cfg, 1.0, 6.6)
    cola = torch.as_tensor(wsola_fast._cola_hann(2 * hop))
    span = _span_route(xs, a_i, a_f, pos, hop, cap, cfg, 6.6)
    fused = kernels.gather_synth_reference(
        xs, a_i, a_f, cola, torch.ones(1), pos.valid, hop, cap)[0]
    assert float((span - fused).abs().max()) < 1e-6
    r = wsola_fast.time_scale_grid(x, speeds, cfg, min_speed_bound=1.0,
                                   max_speed_bound=6.6, device="cpu")
    assert int(r.valid_length) == int(pos.valid[0]) > 0
    assert float((span - r.output).abs().max()) < 1e-6
