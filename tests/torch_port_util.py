"""Shared helpers of the tests that hold the PyTorch port (speedy_tpu_torch)
against the JAX package: seeded signals, the JAX package's plain pitch
search, and the attribution of output differences to pitch-period ties."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import testutil


def speech_families(L: int, sr: int, B: int, seed: int = 0) -> np.ndarray:
    """[B, L] float32: the benchmark's synthetic families (two speech-like
    harmonic signals with syllable envelopes, noise bursts, a pitch chirp;
    bench.py:298-316), row b taking family b % 4."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / sr

    def speechlike(f0_base, f0_mod, f0_rate, syll_hz, n_harm):
        f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
        phase = np.cumsum(2 * np.pi * f0 / sr)
        voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
        envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
        return (voiced * envelope * 0.2).astype(np.float32)

    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / sr)
    fams = [
        speechlike(110.0, 30.0, 0.7, 2.5, 5),
        speechlike(210.0, 45.0, 1.3, 4.0, 7),
        (rng.standard_normal(L) * 0.12 * bursts).astype(np.float32),
        ((np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
         * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None) * 0.2
         ).astype(np.float32),
    ]
    return np.stack([fams[b % 4] for b in range(B)])


def pitch_segments(x: np.ndarray, G: int, n_grid: int, seg_w: int) -> np.ndarray:
    """[B, n_grid, seg_w]: cell g's window x[g*G : g*G + seg_w], zero past L."""
    B, L = x.shape
    xp = np.zeros((B, n_grid * G), np.float32)
    xp[:, :L] = x
    return xp.reshape(B, n_grid, G)[:, :, :seg_w]


def jax_pitch_grid(x, gain, taps, minp, maxp, G, n_grid) -> np.ndarray:
    """The JAX package's off-TPU pitch search (wsola_fast.py's ssd_matmul +
    parabolic_min, :446-483) over the gain-scaled grid cells, traced as one
    jitted program as the engine traces it (eager dispatch would round the
    fused elementwise steps differently)."""
    seg_w = taps + maxp
    xg = x if gain is None else x * np.asarray(gain, np.float32)[:, None]
    seg = pitch_segments(xg, G, n_grid, seg_w)
    return np.array(_jax_pitch_search(seg, taps, minp, maxp))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_pitch_search(seg, taps, minp, maxp):
    from speedy_tpu.ops import wsola_fast as jwf

    seg_w = taps + maxp
    M = jwf._pitch_dft_size(max(seg_w, taps + maxp))
    nb, nl = M // 2 + 1, maxp - minp + 1
    Ea, Es, Inv, Band = (
        jnp.asarray(m) for m in jwf._pitch_corr_matrices(taps, seg_w, minp, maxp, M)
    )
    hi = jax.lax.Precision.HIGHEST
    FA = jnp.einsum("bgt,tk->bgk", seg[..., :taps], Ea, precision=hi)
    FS = jnp.einsum("bgt,tk->bgk", seg, Es, precision=hi)
    AR, AI, SR, SI = FA[..., :nb], FA[..., nb:], FS[..., :nb], FS[..., nb:]
    cc = jnp.einsum("bgk,kl->bgl", AR * SR + AI * SI, Inv[:nb], precision=hi) + (
        jnp.einsum("bgk,kl->bgl", AR * SI - AI * SR, Inv[nb:], precision=hi)
    )
    E = jnp.einsum("bgt,tl->bgl", seg * seg, Band, precision=hi)
    ssd = E[..., nl:] + E[..., :nl] - 2.0 * cc
    jc = jnp.clip(jnp.argmin(ssd, axis=-1), 1, nl - 2)
    take = lambda off: jnp.take_along_axis(ssd, (jc + off)[..., None], axis=2)[..., 0]
    l, m, r = take(-1), take(0), take(1)
    den = l - 2.0 * m + r
    frac = jnp.where(jnp.abs(den) > 1e-12, 0.5 * (l - r) / den, 0.0)
    return (minp + jc).astype(jnp.float32) + jnp.clip(frac, -0.5, 0.5)


def cpu_tables(cfg) -> dict:
    from speedy_tpu_torch.parallel.batch import device_tables

    return device_tables(cfg, "cpu")


def flip_attributed_mask(valid, speeds, dper, step, G, seg_w, maxp, hop, capacity):
    """[B, capacity] bool: output samples whose source position (through
    the speed time map) lies within the neighbourhood of a grid cell whose
    two periods differ (the attribution of
    tests/test_pallas_kernels.py:717-749)."""
    B = len(valid)
    margin = G + seg_w + 2 * maxp + hop  # source-sample slack
    near = np.zeros((B, capacity), bool)
    for b in range(B):
        cells = np.flatnonzero(dper[b] > 0)
        if cells.size == 0:
            continue
        o_of_f = np.concatenate([[0.0], np.cumsum(step / speeds[b].astype(np.float64))])
        src = np.searchsorted(o_of_f, np.arange(capacity, dtype=np.float64)) * step
        centers = cells * G + G / 2
        near[b] = np.min(np.abs(src[:, None] - centers[None, :]), axis=1) <= margin
    return near


def assert_outputs_agree_up_to_ties(
    y_ref, y_got, valid, speeds, x, per_ref, per_got, cfg, hop
):
    """Both paths' outputs agree (max|d| < 2e-3, mean < 1e-5) away from the
    cells whose two pitch periods differ; every such flip is a float64 SSD
    tie; and differences above 1e-3 cover under 2% of the valid samples
    (tests/test_pallas_kernels.py:708-750)."""
    from speedy_tpu_torch.ops.wsola_fast import pitch_grid_stride

    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    taps, seg_w = maxp, 2 * maxp
    G = pitch_grid_stride(cfg, hop)
    n_grid = per_ref.shape[1]
    segs = pitch_segments(x, G, n_grid, seg_w)
    testutil.assert_period_flips_are_ties(segs, per_ref, per_got, taps, minp, maxp)
    dper = np.abs(per_ref - per_got)
    cap = y_ref.shape[1]
    near = flip_attributed_mask(
        valid, speeds, dper, cfg.frame_step_int, G, seg_w, maxp, hop, cap
    )
    d = np.abs(y_ref - y_got)
    clean = ~near
    if clean.any():
        assert d[clean].max() < 2e-3, ("output diff away from any period flip",
                                       d[clean].max())
        assert d[clean].mean() < 1e-5, d[clean].mean()
    total = int(np.sum(valid))
    bad = int(np.count_nonzero(d > 1e-3))
    assert bad / max(total, 1) < 0.02, (bad, total)


def mask_edge_margins(x: np.ndarray, cfg, T: int, integer_step: bool) -> np.ndarray:
    """[T - hysteresis_future]: for each tension frame t, the smallest
    relative distance of a bin 1..W-1 of frame t or t-1 to frame t's 40 dB
    mask threshold max(|X_t|)/100, from a float64 spectrogram at the
    integer- or float-step frame starts (the predicate of
    testutil.assert_tension_outliers_are_mask_edges, which assumes
    integer-step frames)."""
    from speedy_tpu_torch.ops.framing import frame_starts

    W = cfg.window_size
    starts = frame_starts(cfg, T, integer_step)
    x = np.asarray(x, np.float64)
    idx = np.clip(starts[:, None] + np.arange(W)[None, :], 0, len(x) - 1)
    frames = x[idx]
    state = np.concatenate([[0.0], x[np.clip(starts[:-1] + W - 1, 0, len(x) - 1)]])
    pre = frames - 0.97 * np.concatenate([state[:, None], frames[:, :-1]], axis=1)
    i = np.arange(W, dtype=np.float64)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (W - 1.0))
    spec = np.abs(np.fft.rfft(pre * win, n=2 * W, axis=1))[:, 1:W]
    T_out = T - cfg.hysteresis_future
    cur = spec[:T_out]
    last = np.concatenate([np.zeros((1, W - 1)), spec[: T_out - 1]])
    thresh = cur.max(axis=1, keepdims=True) / 100.0
    d = np.minimum(np.abs(cur - thresh), np.abs(last - thresh))
    return d.min(axis=1) / np.maximum(thresh[:, 0], 1e-300)


def assert_tension_gate(x, cfg, T, t_ref, t_got, integer_step=True):
    """Tension within 2e-5 (tests/test_chunked.py:38) except at 40 dB
    mask-edge frames (relative margin under 1e-4)."""
    diffs = np.abs(np.asarray(t_got) - np.asarray(t_ref))
    out = np.flatnonzero(diffs > 2e-5)
    if out.size:
        margins = mask_edge_margins(x, cfg, T, integer_step)
        for t in out:
            assert margins[t] < 1e-4, ("tension outlier off the mask edge",
                                       int(t), float(diffs[t]), float(margins[t]))


def single_pitch_grids(x, speeds, cfg, min_speed_bound, max_speed_bound=None):
    """(the JAX engine's pitch grid, the port's plain one), each [1, n_grid],
    for one utterance x [L] as time_scale_grid searches it.

    The JAX engine's grid is read back from _wsola_grid_batch itself
    (return_period=True gives each chunk's period; a chunk's cell comes
    from the time map): a pitch search traced outside the engine
    (jax_pitch_grid) pads the cells to another count, and XLA then rounds
    its products differently, which moves near-tied cells by whole lags."""
    from speedy_tpu.ops import wsola_fast as jwf
    from speedy_tpu_torch.ops import kernels
    from speedy_tpu_torch.ops.wsola_fast import (
        grid_positions, pitch_corr_matrices, pitch_grid_stride, plan_grid,
    )

    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    G = pitch_grid_stride(cfg)
    n_grid = -(-(len(x) + 2 * maxp) // G)
    xb = np.array(x, np.float32)[None]
    sp = np.array(speeds, np.float32)[None]
    hop, cap, K = plan_grid(cfg, len(x), min_speed_bound)
    _, per = jwf._wsola_grid_batch(
        jnp.asarray(xb), jnp.asarray([len(x)], jnp.int32), jnp.asarray(sp),
        minp, maxp, cfg.frame_step_int, hop, cap, K,
        max_speed_plan=max_speed_bound, return_period=True,
    )
    grid_j = jax_pitch_grid(xb, None, maxp, minp, maxp, G, n_grid)
    cells = grid_positions(
        torch.tensor([len(x)], dtype=torch.int32), torch.as_tensor(sp),
        torch.as_tensor(grid_j), cfg.frame_step_int, hop, G, cap, K, max_speed_bound,
    ).cell.numpy()[0]
    per = np.asarray(per)[0]
    for c in np.unique(cells):
        assert np.all(per[cells == c] == per[cells == c][0]), c
        grid_j[0, c] = per[cells == c][0]
    corr = tuple(torch.as_tensor(m) for m in pitch_corr_matrices(cfg))
    grid_t = kernels.pitch_ssd_reference(
        torch.as_tensor(xb), torch.ones(1), maxp, minp, maxp, G, n_grid, corr
    ).numpy()
    return grid_j, grid_t


def tipped_slots(x, n, speeds_a, speeds_b, grid, cfg) -> np.ndarray:
    """[n] bool: the output samples of one utterance in the two slots fed by
    a chunk whose pitch cell or phase snap rounds differently under two
    nearly equal speed sequences (the attribution of
    test_torch_pipeline.py::test_grid_positions_move_only_where_a_rounding_tips:
    elsewhere a chunk's source position does not depend on float32
    rounding of the speeds)."""
    from speedy_tpu_torch.ops.wsola_fast import (
        default_hop, grid_positions, pitch_grid_stride,
    )

    hop = default_hop(cfg)
    K = n // hop + 2
    lens = torch.tensor([len(x)], dtype=torch.int32)
    pa, pb = (
        grid_positions(lens, torch.tensor(np.asarray(s, np.float32)).reshape(1, -1),
                       torch.as_tensor(grid), cfg.frame_step_int, hop,
                       pitch_grid_stride(cfg), K * hop, K)
        for s in (speeds_a, speeds_b)
    )
    tipped = ((pa.cell != pb.cell) | (pa.snap != pb.snap))[0].numpy()
    touched = tipped.copy()
    touched[1:] |= tipped[:-1]
    return np.repeat(touched, hop)[:n]


def assert_singles_agree(
    xs, ys_ref, ys_got, speeds_ref, speeds_got, cfg, min_speed_bounds,
    max_speed_bound=None,
):
    """Single-utterance outputs of equal-length inputs xs [B, L] (ys_*: B
    float arrays, each pair trimmed to its equal valid length; ys_ref from
    the JAX package at speeds_ref [B, F]) agree as a batch up to pitch
    ties (assert_outputs_agree_up_to_ties against the JAX engine's own
    grids), outside the slots of chunks that the float32 difference of the
    two speed sequences tips (tipped_slots; at most 1% of the chunks)."""
    from speedy_tpu_torch.ops.wsola_fast import default_hop

    B = len(xs)
    hop = default_hop(cfg)
    n = [len(y) for y in ys_ref]
    cap = max(n)
    y_ref, y_got = np.zeros((B, cap), np.float32), np.zeros((B, cap), np.float32)
    grids_j, grids_t = [], []
    for b in range(B):
        assert len(ys_got[b]) == n[b], (b, len(ys_got[b]), n[b])
        gj, gt = single_pitch_grids(
            xs[b], speeds_ref[b], cfg, min_speed_bounds[b], max_speed_bound
        )
        grids_j.append(gj[0])
        grids_t.append(gt[0])
        keep = ~tipped_slots(xs[b], n[b], speeds_ref[b], speeds_got[b], gj, cfg)
        assert (~keep).sum() <= 2 * hop * max(1, n[b] // hop // 100), (b, (~keep).sum())
        y_ref[b, : n[b]] = np.asarray(ys_ref[b], np.float32) * keep
        y_got[b, : n[b]] = np.asarray(ys_got[b], np.float32) * keep
    assert_outputs_agree_up_to_ties(
        y_ref, y_got, np.asarray(n), np.asarray(speeds_ref, np.float32),
        np.asarray(xs, np.float32), np.stack(grids_j), np.stack(grids_t), cfg, hop,
    )
