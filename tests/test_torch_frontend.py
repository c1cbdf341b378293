"""The PyTorch port's analysis front-end, pitch search and speed laws
against the JAX package on the CPU, on the same seeded inputs. On CPU
tensors the kernel wrappers run their plain versions, which are what these
tests hold against the JAX package's Pallas kernels (interpret mode) and
its XLA chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speedy_tpu.ops.pallas_kernels as pk
from speedy_tpu.config import SpeedyConfig as JConfig
from speedy_tpu.ops import filters as jfilters
from speedy_tpu.ops import speed as jspeed
from speedy_tpu.parallel import batch as jbatch

from speedy_tpu_torch import trace
from speedy_tpu_torch.config import SpeedyConfig
from speedy_tpu_torch.ops import filters, kernels, speed
from speedy_tpu_torch.ops.wsola_fast import pitch_grid_stride
from speedy_tpu_torch.parallel import batch

import testutil
from torch_port_util import cpu_tables, jax_pitch_grid, pitch_segments

GAIN = np.array([1.0, 0.7, 1.4], np.float32)


def _analysis_batch(L, sr):
    """Voiced, noise and bursty rows (tests/test_pallas_kernels.py:451)."""
    rng = np.random.default_rng(7)
    t = np.arange(L) / sr
    voiced = (
        np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 2.3 * t), 0, None)
    ).astype(np.float32) * 0.4
    noise = rng.standard_normal(L).astype(np.float32) * 0.05
    bursty = np.zeros(L, np.float32)
    bursty[4000:12000] = voiced[:8000]
    return np.stack([voiced, noise, bursty])


@pytest.mark.parametrize("sr,L", [(16000, 32000), (22050, 44100)])
def test_analysis_reference_matches_pallas_kernel(sr, L):
    cfg = SpeedyConfig(sr)
    W, step = cfg.window_size, cfg.frame_step_int
    xs = _analysis_batch(L, sr)
    T = (L - W) // step + 1
    e_k, l_k = pk.analysis_energy_lsd_pallas(
        jnp.asarray(xs), T, W, step, gain=jnp.asarray(GAIN),
        precision="highest", interpret=True,
    )
    e_k, l_k = np.asarray(e_k), np.asarray(l_k)
    tab = cpu_tables(cfg)
    e_t, l_t = kernels.analysis_energy_lsd(
        torch.as_tensor(xs), torch.as_tensor(GAIN), tab["hamming"],
        tab["dft_cos"], tab["dft_sin"], tab["analysis_fft"], T, step,
    )
    np.testing.assert_allclose(e_t.numpy(), e_k, rtol=1e-5, atol=1e-6)
    # lsd[:, 0] is don't-care; at most 2 frames may differ by a 40 dB
    # mask-edge flip (the rule of tests/test_pallas_kernels.py:506-511).
    scale = float(np.abs(l_k).max())
    dl = np.abs(l_t.numpy()[:, 1:] - l_k[:, 1:])
    n_out = int((dl > 2e-4 * max(scale, 1.0)).sum())
    rel = dl / (np.abs(l_k[:, 1:]) + 1.0)
    assert n_out <= 2 and rel.max() < 1e-2, (n_out, dl.max(), rel.max())
    assert not any(trace.LAUNCHES.values())


@pytest.mark.parametrize("sr,L", [(16000, 48000), (22050, 44100)])
def test_batched_analysis_matches_jax(monkeypatch, sr, L):
    monkeypatch.setenv("SPEEDY_ANALYSIS_PRECISION", "highest")
    cfg = SpeedyConfig(sr)
    xs = _analysis_batch(L, sr)
    T = cfg.num_frames(L, integer_step=True)
    t_j = np.asarray(
        jbatch.batched_analysis(jnp.asarray(xs), JConfig(sr), T, gain=jnp.asarray(GAIN))
    )
    t_t = batch.batched_analysis(
        torch.as_tensor(xs), cfg, T, torch.as_tensor(GAIN)
    ).numpy()
    assert t_t.shape == t_j.shape == (3, cfg.num_tension_frames(T))
    for b in range(3):
        diffs = np.abs(t_t[b] - t_j[b])
        testutil.assert_tension_outliers_are_mask_edges(
            xs[b], cfg, T, diffs, outlier_thresh=2e-5
        )


@pytest.mark.parametrize("sr,L", [(16000, 64000), (22050, 88200)])
def test_pitch_reference_matches_pallas_and_einsum(sr, L):
    cfg = SpeedyConfig(sr)
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    taps, seg_w = maxp, 2 * maxp
    G = pitch_grid_stride(cfg)
    n_grid = -(-(L + seg_w) // G)
    rng = np.random.default_rng(5)
    t = np.arange(L) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.6 * t)
    x = np.stack([
        (0.4 * np.sin(np.cumsum(2 * np.pi * f0 / sr))).astype(np.float32),
        (rng.standard_normal(L) * 0.3).astype(np.float32),
    ])
    gain = np.array([1.0, 0.8], np.float32)

    got = kernels.pitch_ssd(
        torch.as_tensor(x), torch.as_tensor(gain), taps, minp, maxp, G, n_grid,
        tuple(cpu_tables(cfg)[k] for k in ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band")),
    ).numpy()
    assert got.shape == (2, n_grid)
    segs = pitch_segments(x, G, n_grid, seg_w)

    n_cells = -(-n_grid // 64) * 64
    xg = np.zeros((2, n_cells * G), np.float32)
    xg[:, :L] = x
    pallas = np.asarray(
        pk.pitch_ssd_pallas(
            jnp.asarray(xg.reshape(2, n_cells, G)), taps, minp, maxp,
            interpret=True, gain=jnp.asarray(gain),
        )
    )[:, :n_grid]
    einsum = jax_pitch_grid(x, gain, taps, minp, maxp, G, n_grid)
    for ref in (pallas, einsum):
        d = np.abs(ref - got)
        assert np.mean(d > 0.1) < 0.005, (d.max(), np.argwhere(d > 0.1)[:5])
        testutil.assert_period_flips_are_ties(segs, ref, got, taps, minp, maxp)


def test_lowpass_matches_associative_scan():
    rng = np.random.default_rng(2)
    x = (np.abs(rng.standard_normal((3, 999))) * 3).astype(np.float32)
    alpha = SpeedyConfig(16000).lpf_alpha
    for init in (2.14204, 123.837):
        y_j = np.asarray(jfilters.first_order_lowpass(jnp.asarray(x), alpha, init))
        y_t = filters.first_order_lowpass(torch.as_tensor(x), alpha, init).numpy()
        np.testing.assert_allclose(y_t, y_j, rtol=5e-6, atol=0)
    for T in (1, 63, 64, 65):
        y_j = np.asarray(jfilters.first_order_lowpass(jnp.asarray(x[:, :T]), alpha, 2.0))
        y_t = filters.first_order_lowpass(torch.as_tensor(x[:, :T]), alpha, 2.0).numpy()
        np.testing.assert_allclose(y_t, y_j, rtol=5e-6, atol=0)


@pytest.mark.parametrize("rate", [3.5, 0.7])
def test_speed_laws_match_jax(rate):
    rng = np.random.default_rng(3)
    tension = (rng.standard_normal((3, 999)) * 0.5).astype(np.float32)
    seq_j = np.asarray(
        jax.vmap(lambda t: jspeed.speed_from_tension(t, rate, 0.1, 1.0)[0])(
            jnp.asarray(tension)
        )
    )
    seq_t, _ = speed.speed_from_tension(torch.as_tensor(tension), rate, 0.1, 1.0)
    np.testing.assert_allclose(seq_t.numpy(), seq_j, rtol=1e-6, atol=1e-6)
    if rate > 1.0:
        par_j = np.asarray(
            jspeed.speed_from_tension_parallel(jnp.asarray(tension), rate, 0.1, 1.0)
        )
        par_t = speed.speed_from_tension_parallel(
            torch.as_tensor(tension), rate, 0.1, 1.0
        ).numpy()
        np.testing.assert_allclose(par_t, par_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(par_t, seq_t.numpy(), rtol=1e-5, atol=1e-5)
    else:
        with pytest.raises(ValueError):
            speed.speed_from_tension_parallel(torch.as_tensor(tension), rate)
