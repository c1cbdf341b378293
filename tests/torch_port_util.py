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
