#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Builds the port's CUDA kernels from speedy_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version on the card, and drives the
port's two paths, each against the same call through the plain versions:
  - the batched path (SpeedupEngine: B=128 utterances of 10 s at 16 kHz,
    3.5x, capacity factor 1.33, per-utterance gain), then the dryrun sweep
    cases (0.7x with a ragged length; 22.05 kHz 3.0x);
  - the single-utterance grid pipeline (pipeline.nonlinear_speedup on 60 s
    at 16 kHz, 3.5x; linear_time_scale at 44.1 kHz, 2.0x and the 1.0x
    pass-through; time_scale_grid with a speed ceiling against without
    one), and its CLI in a subprocess against the same call in process.
Prints one line per phase, a JSON line of the kernels' launches, errors
and times, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failed check raises, so the exit code
is non-zero and no result line is printed. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCES = {
    "analysis_energy_lsd": ("speedy_tpu_torch/csrc/analysis.cu",
                            "speedy_tpu/ops/pallas_kernels.py:1700"),
    "pitch_ssd": ("speedy_tpu_torch/csrc/pitch.cu",
                  "speedy_tpu/ops/pallas_kernels.py:1235"),
    "gather_synth": ("speedy_tpu_torch/csrc/synth.cu",
                     "speedy_tpu/ops/pallas_kernels.py:653"),
    "gather_rows": ("speedy_tpu_torch/csrc/gather_rows.cu",
                    "speedy_tpu/ops/pallas_kernels.py:121"),
}
# The batched path's kernels; the single-utterance path runs pitch_ssd and
# gather_rows.
BATCH_KERNELS = ("analysis_energy_lsd", "pitch_ssd", "gather_synth")
CORR = ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band")
STEP_WINDOWS, STEPS_PER_WINDOW = 5, 10


class SmokeFailure(AssertionError):
    pass


def check(ok, *what):
    if not ok:
        raise SmokeFailure(" ".join(str(w) for w in what))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def bench_families(L: int, sr: int, seed: int = 0) -> np.ndarray:
    """[4, L] float32: the four synthetic families of bench.py:295-316
    (copied: bench.py imports JAX)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / sr

    def speechlike(f0_base, f0_mod, f0_rate, syll_hz, n_harm):
        f0 = f0_base + f0_mod * np.sin(2 * np.pi * f0_rate * t)
        phase = np.cumsum(2 * np.pi * f0 / sr)
        voiced = sum(np.sin(k * phase) / k for k in range(1, n_harm + 1))
        envelope = np.clip(np.sin(2 * np.pi * syll_hz * t), 0, None)
        return (voiced * envelope * 0.2).astype(np.float32)

    fam0 = speechlike(110.0, 30.0, 0.7, 2.5, 5)
    fam1 = speechlike(210.0, 45.0, 1.3, 4.0, 7)
    bursts = (np.sin(2 * np.pi * 3.1 * t) > 0.3).astype(np.float32)
    fam2 = (rng.standard_normal(L) * 0.12 * bursts).astype(np.float32)
    chirp_f0 = 90.0 + 160.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t))
    phase_c = np.cumsum(2 * np.pi * chirp_f0 / sr)
    fam3 = (
        (np.sin(phase_c) + 0.5 * np.sin(2 * phase_c))
        * np.clip(np.sin(2 * np.pi * 1.8 * t + 0.7), 0, None)
        * 0.2
    ).astype(np.float32)
    return np.stack([fam0, fam1, fam2, fam3])


def batch_of(families: np.ndarray, B: int) -> np.ndarray:
    return np.ascontiguousarray(families[np.arange(B) % len(families)])


def sweep_input(B: int, L: int, sr: int, f0: float, rng) -> np.ndarray:
    """The dryrun sweep's input (__graft_entry__.py:132-138, 195-201)."""
    xs = np.asarray(rng.normal(size=(B, L)) * 0.1, np.float32)
    t = np.arange(L) / float(sr)
    xs[0] = (
        0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.2 * np.sin(2 * np.pi * 3 * t))
    ).astype(np.float32)
    return xs


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mask_edge_margins(x: np.ndarray, cfg, frames) -> np.ndarray:
    """For each tension frame t in `frames`: the smallest relative distance
    of a bin 1..W-1 of frame t or t-1 to frame t's 40 dB mask threshold
    max(|X_t|)/100, from a float64 spectrogram (the predicate of
    tests/testutil.py::assert_tension_outliers_are_mask_edges)."""
    from speedy_tpu_torch.ops.dft import hamming_window

    W, step = cfg.window_size, cfg.frame_step_int
    win = hamming_window(W, "float64")
    x = x.astype(np.float64)

    def spectrum(f):
        if f < 0:
            return np.zeros(W - 1)
        frame = x[f * step : f * step + W]
        state = x[(f - 1) * step + W - 1] if f > 0 else 0.0
        prev = np.concatenate([[state], frame[:-1]])
        return np.abs(np.fft.rfft((frame - 0.97 * prev) * win, n=2 * W))[1:W]

    out = []
    for t in frames:
        cur, last = spectrum(t), spectrum(t - 1)
        th = cur.max() / 100.0
        d = np.minimum(np.abs(cur - th), np.abs(last - th))
        out.append(d.min() / max(th, 1e-300))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_analysis(kernels, x, gain, tables, cfg, label):
    import torch

    T = cfg.num_frames(x.shape[1], integer_step=True)
    args = (x, gain, tables["hamming"], tables["dft_cos"], tables["dft_sin"],
            tables["tw_cos"], tables["tw_sin"], T, cfg.frame_step_int)
    e_k, l_k = kernels.analysis_energy_lsd(*args)
    e_p, l_p = kernels.analysis_energy_lsd_reference(*args)
    torch.cuda.synchronize()
    e_k, l_k, e_p, l_p = (t.cpu().numpy() for t in (e_k, l_k, e_p, l_p))
    check(np.all(np.isfinite(e_k)) and np.all(np.isfinite(l_k)), label, "non-finite")
    e_err = np.abs(e_k - e_p)
    check(np.all(e_err <= 1e-6 + 1e-5 * np.abs(e_p)), label, "energy",
          float((e_err / (np.abs(e_p) + 1e-6)).max()))
    # lsd[:, 0] is don't-care. Per utterance at most 2 frames beyond
    # 2e-4*max(scale, 1), and relative error below 1e-2 everywhere
    # (tests/test_pallas_kernels.py:506-511).
    dl = np.abs(l_k[:, 1:] - l_p[:, 1:])
    worst_frames, worst_rel = 0, 0.0
    for b in range(x.shape[0]):
        scale = float(np.abs(l_p[b]).max())
        n_out = int((dl[b] > 2e-4 * max(scale, 1.0)).sum())
        rel = float((dl[b] / (np.abs(l_p[b, 1:]) + 1.0)).max())
        worst_frames, worst_rel = max(worst_frames, n_out), max(worst_rel, rel)
    check(worst_frames <= 2 and worst_rel < 1e-2, label, "lsd", worst_frames, worst_rel)
    ms = time_ms(lambda: kernels.analysis_energy_lsd(*args))
    plain_ms = time_ms(lambda: kernels.analysis_energy_lsd_reference(*args))
    err = float(e_err.max())
    emit("kernel", kernel="analysis_energy_lsd", shape=label, energy_max_abs_err=err,
         lsd_max_abs_err=float(dl.max()), lsd_frames_out_max=worst_frames,
         ms=ms, plain_ms=plain_ms)
    return err, ms, plain_ms


def check_pitch(kernels, testutil, x, gain, tables, cfg, label):
    import torch
    from speedy_tpu_torch.ops.wsola_fast import pitch_grid_stride

    B, L = x.shape
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    taps, seg_w = maxp, 2 * maxp
    G = pitch_grid_stride(cfg)
    n_grid = -(-(L + seg_w) // G)
    corr = tuple(tables[k] for k in CORR)
    args = (x, gain, taps, minp, maxp, G, n_grid, corr)
    per_k = kernels.pitch_ssd(*args)
    per_p = kernels.pitch_ssd_reference(*args)
    torch.cuda.synchronize()
    per_x = exact_pitch(kernels, x, gain, taps, minp, maxp, G, n_grid).cpu().numpy()
    per_k, per_p = per_k.cpu().numpy(), per_p.cpu().numpy()
    check(per_k.shape == (B, n_grid) and np.all(np.isfinite(per_k)), label, "period shape")
    # Integer flips between the two must be float64 SSD ties (the plain
    # version's float32 DFT rounding re-ranks near-tied lags of quiet
    # cells); where the integer lag agrees, under 0.5% of cells may part by
    # more than 0.1 sample (tests/test_pallas_kernels.py:400-401).
    d = np.abs(per_k - per_p)
    dk, dp = np.abs(per_k - per_x), np.abs(per_p - per_x)
    flips = d > 0.5
    share = float(np.mean((d > 0.1) & ~flips))
    check(share < 0.005, label, "cells off by > 0.1 sample", share)
    xp = np.zeros((B, n_grid * G), np.float32)
    xp[:, :L] = x.cpu().numpy()
    segs = xp.reshape(B, n_grid, G)[:, :, :seg_w]
    testutil.assert_period_flips_are_ties(segs, per_p, per_k, taps, minp, maxp)
    ms = time_ms(lambda: kernels.pitch_ssd(*args))
    plain_ms = time_ms(lambda: kernels.pitch_ssd_reference(*args))
    err = float(d.max())
    emit("kernel", kernel="pitch_ssd", shape=label, G=G, cells=B * n_grid,
         max_abs_err=err, share_off_0p1_same_lag=share,
         integer_flips=int(flips.sum()), kernel_share_off_f64_0p1=float(np.mean(dk > 0.1)),
         plain_share_off_f64_0p1=float(np.mean(dp > 0.1)),
         kernel_max_off_f64=float(dk.max()), plain_max_off_f64=float(dp.max()),
         ms=ms, plain_ms=plain_ms)
    return err, ms, plain_ms


def exact_pitch(kernels, x, gain, taps, minp, maxp, G, n_grid):
    """The pitch search in float64 on the card, straight from its
    definition SSD(l) = sum_{i<taps} (seg[i] - seg[i+l])^2, with the same
    first-argmin and parabolic refine."""
    import torch

    B, L = x.shape
    seg_w = taps + maxp
    xg = (x * gain[:, None]).double()
    xg = torch.cat([xg, xg.new_zeros(B, n_grid * G - L)], dim=1)
    segs = xg.reshape(B, n_grid, G)[:, :, :seg_w]
    lags = torch.arange(minp, maxp + 1, device=x.device)
    out = []
    for b in range(B):
        s = segs[b]
        win = s.unfold(1, taps, 1)[:, lags]  # [n_grid, n_lags, taps]
        ssd = ((s[:, None, :taps] - win) ** 2).sum(-1)
        out.append(kernels._parabolic_min(ssd, minp))
    return torch.stack(out)


def synth_case(B, L, hop, K, rate, seed, device):
    """Near-monotone chunk positions as the grid engine produces them:
    steps of about rate*hop with a phase jitter, clipped to [0, L-1]."""
    import torch

    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.6 * rate * hop, 1.4 * rate * hop, (B, K))
    a = np.minimum(np.cumsum(steps, axis=1) - steps[:, :1], L - 1.0)
    a_i = np.floor(a).astype(np.int32)
    a_f = (a - a_i).astype(np.float32)
    capacity = (K - 1) * hop
    valid = rng.integers(capacity // 2, capacity + 1, B).astype(np.int32)
    valid[0] = capacity
    t = lambda v: torch.as_tensor(v, device=device)
    return t(a_i), t(a_f), t(valid), capacity


def check_synth(kernels, x, gain, hop, K, rate, label):
    import torch
    from speedy_tpu_torch.ops.wsola_fast import _cola_hann

    B, L = x.shape
    a_i, a_f, valid, capacity = synth_case(B, L, hop, K, rate, 11, x.device)
    win = torch.as_tensor(_cola_hann(2 * hop), device=x.device)
    args = (x, a_i, a_f, win, gain, valid, hop, capacity)
    out_k = kernels.gather_synth(*args)
    out_p = kernels.gather_synth_reference(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(bool(torch.isfinite(out_k).all()), label, "non-finite")
    check(err <= 1e-5, label, "max|d|", err)
    ms = time_ms(lambda: kernels.gather_synth(*args))
    plain_ms = time_ms(lambda: kernels.gather_synth_reference(*args))
    emit("kernel", kernel="gather_synth", shape=label, max_abs_err=err, ms=ms,
         plain_ms=plain_ms)
    return err, ms, plain_ms


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path against the plain path
# ---------------------------------------------------------------------------


def compare_paths(batch, kernels, xs, lengths, gain, cfg, rate, cap_factor, res, label):
    """The kernel path's result `res` against the same call through the
    plain versions on the card:
      - equal valid lengths, and tension within 2e-5 except at 40 dB
        mask-edge frames;
      - fed the kernel path's speeds and pitch grid, the plain grid engine
        gives max|d| < 2e-3 and mean < 1e-5 (__graft_entry__.py:178-179);
      - the whole plain path, fed the kernel path's grid, keeps mean < 1e-5
        and max|d| < 2e-3 on every sample outside the output slots of
        chunks whose pitch cell or phase snap rounds differently in the two
        paths (see below), and such chunks are under 0.1% of the live ones;
      - with its own grid, under 2% of the valid samples are off by more
        than 1e-3 (tests/test_pallas_kernels.py:750)."""
    import torch
    from speedy_tpu_torch.ops import wsola_fast

    common = dict(capacity_factor=cap_factor, reference=True)
    plan = batch._plan_max_speed(rate, 1.0)
    plain = batch.batched_nonlinear_speedup(
        xs, lengths, cfg, rate, 1.0, 0.1, gain=gain, **common
    )
    check(torch.equal(plain.valid_length, res.valid_length), label, "valid_length differs",
          int((plain.valid_length != res.valid_length).sum()))
    dt = (plain.tension - res.tension).abs().cpu().numpy()
    edges = 0
    if dt.size:
        x_np = xs.cpu().numpy()
        for b, t in np.argwhere(dt > 2e-5):
            m = mask_edge_margins(x_np[b], cfg, [int(t)])[0]
            check(m < 1e-4, label, "tension outlier not at a mask edge", b, t,
                  float(dt[b, t]), m)
            edges += 1

    B, L = xs.shape
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    hop = wsola_fast.default_hop(cfg)
    G = wsola_fast.pitch_grid_stride(cfg, hop)
    n_grid = -(-(L + 2 * maxp) // G)
    g = torch.ones(B, device=xs.device) if gain is None else gain
    tables = batch.device_tables(cfg, xs.device)
    corr = tuple(tables[k] for k in CORR)
    grid = kernels.pitch_ssd(xs, g, maxp, minp, maxp, G, n_grid, corr)
    capacity = res.output.shape[1]
    K = capacity // hop + 1
    lens32 = lengths.to(torch.int32)
    engine = wsola_fast.wsola_grid_batch(
        xs, lens32, res.speeds, minp, maxp, cfg.frame_step_int, hop, capacity, K,
        tables["cola"], corr, max_speed_plan=plan, gain=gain, period_grid=grid,
        reference=True,
    )
    d_eng = (engine.output - res.output).abs()
    eng_max, eng_mean = float(d_eng.max()), float(d_eng.mean())
    check(eng_max < 2e-3 and eng_mean < 1e-5, label, "fed grid engine", eng_max, eng_mean)
    fed = batch.batched_nonlinear_speedup(
        xs, lengths, cfg, rate, 1.0, 0.1, gain=gain, period_grid=grid, **common
    )
    check(torch.equal(fed.valid_length, res.valid_length), label, "fed valid_length")
    d_fed = (fed.output - res.output).abs()
    fed_max, fed_mean = float(d_fed.max()), float(d_fed.mean())
    check(fed_mean < 1e-5, label, "fed-grid path mean", fed_mean)
    # The plain path computes its own tension, so its chunk positions c_k
    # differ from the kernel path's by float32 rounding. A chunk whose
    # pitch cell round(c/G) or phase snap round(delta/period) sits on a
    # rounding boundary then moves by a period. Name those chunks from both
    # paths' own positions: chunk k feeds output slots k and k+1, and every
    # sample outside such slots is held to max|d| < 2e-3.
    pk, pp = (
        wsola_fast.grid_positions(lens32, r.speeds, grid, cfg.frame_step_int, hop, G,
                                  capacity, K, max_speed_plan=plan)
        for r in (res, fed)
    )
    live = torch.arange(K, device=xs.device)[None, :] * hop < res.valid_length[:, None]
    tipped = live & ((pk.cell != pp.cell) | (pk.snap != pp.snap))
    touched = tipped.clone()
    touched[:, 1:] |= tipped[:, :-1]
    near = touched.repeat_interleave(hop, dim=1)[:, :capacity]
    far_max = float(d_fed[~near].max())
    n_tipped = int(tipped.sum())
    tipped_share = n_tipped / max(int(live.sum()), 1)
    check(far_max < 2e-3, label, "fed-grid path max|d| outside tipped chunks", far_max)
    check(tipped_share < 1e-3, label, "tipped chunks", n_tipped, tipped_share)
    steady = live & ~tipped
    shift = float((pk.a - pp.a).abs()[steady].max()) if bool(steady.any()) else 0.0
    d_own = (plain.output - res.output).abs()
    valid_total = max(int(res.valid_length.sum()), 1)
    share = float((d_own > 1e-3).sum()) / valid_total
    check(share < 0.02, label, "own-grid share of |d| > 1e-3", share)
    return dict(tension_max_abs_err=float(dt.max()) if dt.size else 0.0,
                tension_mask_edge_frames=edges,
                engine_fed_max_abs_err=eng_max, engine_fed_mean_abs_err=eng_mean,
                path_fed_max_abs_err=fed_max, path_fed_mean_abs_err=fed_mean,
                path_fed_max_abs_err_outside_tipped=far_max,
                path_fed_tipped_chunks=n_tipped,
                path_fed_tipped_snap=int((tipped & (pk.snap != pp.snap)).sum()),
                path_fed_tipped_cell=int((tipped & (pk.cell != pp.cell)).sum()),
                path_fed_position_shift_max=shift,
                path_fed_share_over_2e3=float((d_fed > 2e-3).sum()) / valid_total,
                own_share_over_1e3=share, own_max_abs_err=float(d_own.max()),
                own_mean_abs_err=float(d_own.mean()))


# ---------------------------------------------------------------------------
# Kernel 4 against its plain version
# ---------------------------------------------------------------------------


def recorded_call(module, name, run):
    """The positional arguments of the first call of module.name while
    run() runs (the call itself goes through)."""
    calls = []
    orig = getattr(module, name)

    def record(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, orig)
    check(bool(calls), name, "was not called")
    return calls[0]


def gather_case(xs, cfg, rate, seed):
    """Kernel 4's inputs as the per-row synthesis builds them for xs [B, L]
    at about `rate`: the source padded by max_period in front and
    3*max_period + 2*hop behind, monotone chunk starts (synth_case) offset
    by the front pad, K from plan_grid at min_speed_bound 1.0, and n_valid
    = valid // hop + 2 for valid lengths around L / rate."""
    import torch
    from speedy_tpu_torch.ops import wsola_fast

    B, L = xs.shape
    maxp = cfg.wsola_max_period
    hop, _, K = wsola_fast.plan_grid(cfg, L, 1.0)
    src = torch.nn.functional.pad(xs, (maxp, 3 * maxp + 2 * hop))
    a_i, _, _, _ = synth_case(B, L, hop, K, rate, seed, xs.device)
    rng = np.random.default_rng(seed)
    valid = (L / rate * rng.uniform(0.9, 1.1, B)).astype(np.int64)
    n_valid = np.minimum(valid // hop + 2, K).astype(np.int32)
    return (src.contiguous(), (a_i + maxp).contiguous(), 2 * hop + 1,
            torch.as_tensor(n_valid, device=xs.device))


def check_gather_rows(kernels, args, label):
    import torch

    src, starts, width, n_valid = args
    rows_k = kernels.gather_rows(src, starts, width, n_valid)
    rows_p = kernels.gather_rows_reference(src, starts, width, n_valid)
    torch.cuda.synchronize()
    check(rows_k.shape == rows_p.shape, label, "shape", tuple(rows_k.shape))
    err = float((rows_k - rows_p).abs().max())
    # A copy: exactly equal, the zero rows past n_valid included.
    check(torch.equal(rows_k, rows_p), label, "rows differ", err)
    ms = time_ms(lambda: kernels.gather_rows(src, starts, width, n_valid))
    plain_ms = time_ms(lambda: kernels.gather_rows_reference(src, starts, width, n_valid))
    B, K = starts.shape
    emit("kernel", kernel="gather_rows", shape=label, B=B, K=K, width=width,
         L=src.shape[1], rows_valid=int(n_valid.clamp(max=K).sum()), max_abs_err=err,
         ms=ms, plain_ms=plain_ms, output_MB=rows_k.numel() * 4 / 1e6)
    return err, ms, plain_ms


# ---------------------------------------------------------------------------
# The single-utterance path against the plain path
# ---------------------------------------------------------------------------


def compare_single(kernels, testutil, wsola_fast, x, cfg, res, plain, label, dev):
    """The kernel path's SpeedupResult `res` for one utterance x [L]
    (float32) against the same call through the plain versions, `plain`:
      - equal valid lengths; tension within 2e-5 except at 40 dB mask-edge
        frames;
      - the plain path fed the kernel path's pitch grid and speeds gives
        max|d| < 2e-3 outside the output slots of chunks whose phase snap
        or pitch cell rounds differently in the two paths, found with
        grid_positions (under 0.1% of the live chunks);
      - with its own pitch grid: the two grids pass the pitch gate (every
        integer flip a float64 SSD tie, under 0.5% of the cells whose
        integer lag agrees parting by more than 0.1 sample), and max|d| <
        2e-3 outside the slots of chunks whose position the two grids
        move. A chunk's position c_0 + k*hop - snap*P multiplies a period
        difference by its snap count, thousands of periods into a long
        utterance, so on 60 s most late chunks move and the share of
        samples off by more than 1e-3 is reported, not gated."""
    import torch

    n = len(res.output)
    check(len(plain.output) == n, label, "valid_length differs", len(plain.output), n)
    dt = np.abs(plain.tension - res.tension)
    edges = 0
    for t in np.flatnonzero(dt > 2e-5):
        m = mask_edge_margins(x, cfg, [int(t)])[0]
        check(m < 1e-4, label, "tension outlier not at a mask edge", t, float(dt[t]), m)
        edges += 1
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    hop = wsola_fast.default_hop(cfg)
    G = wsola_fast.pitch_grid_stride(cfg)
    n_grid = -(-(len(x) + 2 * maxp) // G)
    xt = torch.as_tensor(x, device=dev)
    one = torch.ones(1, device=dev)
    corr = tuple(torch.as_tensor(m, device=dev) for m in wsola_fast.pitch_corr_matrices(cfg))
    grid = kernels.pitch_ssd(xt[None], one, maxp, minp, maxp, G, n_grid, corr)
    msb = max(0.01, float(res.speeds.min()) * 0.999)
    fed = wsola_fast.time_scale_grid(xt, res.speeds, cfg, min_speed_bound=msb,
                                     device=dev, period_grid=grid[0], reference=True)
    check(int(fed.valid_length) == n, label, "fed valid_length")
    y = np.asarray(res.output, np.float32)
    d_fed = np.abs(fed.output[:n].cpu().numpy() - y)
    K = n // hop + 2
    lens = torch.tensor([len(x)], dtype=torch.int32, device=dev)

    def positions(r, g):
        return wsola_fast.grid_positions(
            lens, torch.as_tensor(r.speeds, device=dev)[None], g, cfg.frame_step_int,
            hop, G, K * hop, K)

    def slots(chunks):  # chunk k feeds output slots k and k+1
        touched = chunks.copy()
        touched[1:] |= chunks[:-1]
        return np.repeat(touched, hop)[:n]

    live = n // hop + 1
    pk, pp = positions(res, grid), positions(plain, grid)
    tipped = ((pk.cell != pp.cell) | (pk.snap != pp.snap))[0, :live].cpu().numpy()
    near = slots(tipped)
    far_max = float(d_fed[~near].max()) if (~near).any() else 0.0
    check(far_max < 2e-3, label, "fed-grid path max|d| outside tipped chunks", far_max)
    check(tipped.sum() < max(1.0, 1e-3 * live), label, "tipped chunks", int(tipped.sum()))

    # The plain path's own grid against the kernel's.
    grid_p = kernels.pitch_ssd_reference(xt[None], one, maxp, minp, maxp, G, n_grid, corr)
    g_k, g_p = grid.cpu().numpy(), grid_p.cpu().numpy()
    dg = np.abs(g_k - g_p)
    flips = dg > 0.5
    same_lag_off = float(np.mean((dg > 0.1) & ~flips))
    check(same_lag_off < 0.005, label, "pitch cells off by > 0.1 sample", same_lag_off)
    xp = np.zeros((1, n_grid * G), np.float32)
    xp[0, : len(x)] = x
    testutil.assert_period_flips_are_ties(
        xp.reshape(1, n_grid, G)[:, :, : 2 * maxp], g_p, g_k, maxp, minp, maxp)
    moved = (pk.a != positions(plain, grid_p).a)[0, :live].cpu().numpy()
    d_own = np.abs(np.asarray(plain.output, np.float32) - y)
    still = ~slots(moved)
    own_far_max = float(d_own[still].max()) if still.any() else 0.0
    check(own_far_max < 2e-3, label, "own-grid path max|d| outside moved chunks", own_far_max)
    return dict(valid_length=n, tension_max_abs_err=float(dt.max()) if dt.size else 0.0,
                tension_mask_edge_frames=edges, path_fed_max_abs_err=float(d_fed.max()),
                path_fed_max_abs_err_outside_tipped=far_max,
                path_fed_tipped_chunks=int(tipped.sum()), pitch_cells=n_grid,
                pitch_integer_flips=int(flips.sum()), pitch_same_lag_off_0p1=same_lag_off,
                pitch_max_abs_diff=float(dg.max()), own_chunks=live,
                own_moved_chunks=int(moved.sum()), own_max_abs_err_outside_moved=own_far_max,
                own_share_over_1e3=float((d_own > 1e-3).sum()) / max(n, 1),
                own_max_abs_err=float(d_own.max()))


def path_launches(kernels, run):
    """run() with every launch count set to 0 just before; the counts just
    after, and run()'s result."""
    import torch

    torch.cuda.synchronize()
    kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return dict(kernels.LAUNCHES), out


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall time of fn() in ms, each call ending in a
    synchronize (after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def single_split_ms(x, cfg, rate, dev):
    """Host wall ms (median of 5) of one nonlinear_speedup call on x and of
    its three parts: analysis, the sequential speed law, and the grid
    engine (time_scale_grid, with the read-back of its output)."""
    import torch
    from speedy_tpu_torch import pipeline
    from speedy_tpu_torch.ops import analysis, speed, wsola_fast

    xt = torch.as_tensor(x, device=dev)
    tension = analysis.analyze(xt, cfg, integer_step=True).tension
    speeds = speed.speed_from_tension(tension[None], rate, 0.1, 1.0)[0][0]
    msb = max(0.01, float(speeds.min()) * 0.999)
    return {
        "call": host_ms(lambda: pipeline.nonlinear_speedup(
            x, cfg, rate, 1.0, 0.1, engine="grid", device=dev)),
        "analysis": host_ms(lambda: analysis.analyze(xt, cfg, integer_step=True)),
        "speed_law": host_ms(lambda: speed.speed_from_tension(tension[None], rate, 0.1, 1.0)),
        "engine": host_ms(lambda: wsola_fast.time_scale_grid(
            xt, speeds, cfg, min_speed_bound=msb, device=dev).output.cpu()),
    }


def run_cli_phase(pipeline, wave, cfg, x, dev):
    """The CLI in a subprocess on a WAV of x against nonlinear_speedup on
    the same samples in process: equal samples, equal printed rate."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        wave.write_wave(src, x, cfg.sample_rate)
        samples, _ = wave.read_wave(src)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "speedy_tpu_torch.cli", "--engine", "grid",
             "--device", "cuda", "-s", "3.0", "-i", src, "-o", dst],
            cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600,
        )
        wall_s = time.perf_counter() - t0
        check(proc.returncode == 0, "cli exit", proc.returncode, proc.stderr[-2000:])
        y_cli, sr = wave.read_wave(dst)
    y_in = pipeline.nonlinear_speedup(samples, cfg, 3.0, 1.0, 0.1, engine="grid",
                                      device=dev).output
    check(sr == cfg.sample_rate and y_cli.shape == y_in.shape, "cli shape",
          y_cli.shape, y_in.shape)
    check(np.array_equal(y_cli, y_in), "cli samples differ from the pipeline's",
          int(np.abs(y_cli.astype(np.int32) - y_in).max()))
    rate = f"{len(samples) / len(y_in):.4f}"
    check(f"Achieved overall compression: {rate}x." in proc.stdout, "cli rate",
          proc.stdout[-500:], rate)
    return dict(samples_in=len(samples), samples_out=len(y_cli), achieved_rate=rate,
                subprocess_s=wall_s, stdout_last=proc.stdout.strip().splitlines()[-1])



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs one card", file=sys.stderr)
        return 2
    if not (ROOT / "speedy_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no speedy_tpu_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))  # testutil: numpy-only checks
    import testutil
    from speedy_tpu_torch import SpeedupEngine, SpeedyConfig, pipeline
    from speedy_tpu_torch.io import wave
    from speedy_tpu_torch.ops import _build, kernels, wsola_fast
    from speedy_tpu_torch.parallel import batch

    # ---- 1. device ----
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    batch.no_tf32()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 still on")
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text().splitlines()
    ptxas = [ln.split("ptxas info    : ")[-1] for ln in log
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, library=str(lib_path.relative_to(ROOT)), ptxas=ptxas)

    # ---- 3. kernels against their plain versions ----
    cfg16, cfg22 = SpeedyConfig(16000), SpeedyConfig(22050)
    rng = np.random.default_rng(0)
    B, L = 128, 160000
    xs16 = torch.as_tensor(batch_of(bench_families(L, 16000), B), device=dev)
    gain16 = torch.as_tensor(rng.uniform(0.5, 1.0, B).astype(np.float32), device=dev)
    L22 = 220500
    xs22 = torch.as_tensor(batch_of(bench_families(L22, 22050), 8), device=dev)
    gain22 = torch.as_tensor(rng.uniform(0.5, 1.0, 8).astype(np.float32), device=dev)
    tab16 = {k: v.to(dev) for k, v in batch.SpeedupEngine(cfg16, 3.5).tables().items()}
    tab22 = {k: v.to(dev) for k, v in batch.SpeedupEngine(cfg22, 3.0).tables().items()}
    results = {}
    results["analysis_energy_lsd"] = check_analysis(
        kernels, xs16, gain16, tab16, cfg16, "16kHz B=128 L=160000")
    check_analysis(kernels, xs22, gain22, tab22, cfg22, "22.05kHz B=8 L=220500")
    results["pitch_ssd"] = check_pitch(
        kernels, testutil, xs16, gain16, tab16, cfg16, "16kHz B=128 L=160000 G=512")
    check_pitch(kernels, testutil, xs22, gain22, tab22, cfg22, "22.05kHz B=8 L=220500 G=768")
    results["gather_synth"] = check_synth(
        kernels, xs16, gain16, 160, 383, 3.5, "hop=160 B=128 K=383")
    check_synth(kernels, xs22, gain22, 220, 400, 3.0, "hop=220 B=8 K=400")
    fam44 = bench_families(441000, 44100)
    xs44 = torch.as_tensor(batch_of(fam44, 4), device=dev)
    check_synth(kernels, xs44, gain22[:4].contiguous(), 441, 400, 3.0, "hop=441 B=4 K=400")
    # Kernel 4 at the single-utterance path's own shape (its arguments
    # recorded from one nonlinear_speedup call on 60 s), then at two batch
    # shapes large enough to time.
    cfg44 = SpeedyConfig(44100)
    x60 = bench_families(60 * 16000, 16000)[0]
    path_args = recorded_call(kernels, "gather_rows", lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev))
    results["gather_rows"] = check_gather_rows(
        kernels, path_args, "path: 16kHz B=1 60s 3.5x")
    check_gather_rows(kernels, gather_case(xs16, cfg16, 3.5, 5), "16kHz B=128 L=160000 3.5x")
    xs44b = torch.as_tensor(batch_of(fam44, 16), device=dev)
    check_gather_rows(kernels, gather_case(xs44b, cfg44, 3.5, 6), "44.1kHz B=16 L=441000 3.5x")
    del xs44b

    # ---- 4. the main path ----
    rate, cap_factor = 3.5, 1.33
    engine = SpeedupEngine(cfg16, rate, 1.0, 0.1, capacity_factor=cap_factor).to(dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = engine(xs16, lengths, gain16)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(all(launches[k] > 0 for k in BATCH_KERNELS) and launches["gather_rows"] == 0,
          "main path skipped a kernel or left its route", launches)
    capacity = res.output.shape[1]
    check(capacity == batch.grid_output_capacity(cfg16, L, rate, cap_factor), "capacity")
    max_valid = int(res.valid_length.max())
    check(max_valid < capacity, "truncated output", max_valid, capacity)
    check(bool(torch.isfinite(res.output).all()), "non-finite output")
    check(bool(torch.isfinite(res.tension).all()), "non-finite tension")
    checksum = float(res.output.double().sum())
    cmp = compare_paths(batch, kernels, xs16, lengths, gain16, cfg16, rate, cap_factor,
                        res, "main")
    # Host-clock steps with fresh gains: 2 warm-up steps, then 5 windows of
    # 10; the median over all 50 is the headline, the window medians show
    # the spread within the run.
    windows = []
    for w in range(STEP_WINDOWS + 1):
        steps = []
        for _ in range(2 if w == 0 else STEPS_PER_WINDOW):
            g = torch.as_tensor(rng.uniform(0.5, 1.0, B).astype(np.float32), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine(xs16, lengths, g)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        windows.append(steps)
    timed = [s for steps in windows[1:] for s in steps]
    step_s = statistics.median(timed)
    layers = layer_times(batch, kernels, engine, xs16, lengths, gain16, cfg16, rate)
    busy_ms, n_launches, top = device_profile(lambda: engine(xs16, lengths, gain16))
    emit("main_path", B=B, L=L, sample_rate=16000, rate=rate, capacity=capacity,
         max_valid=max_valid, launches=launches, checksum=checksum,
         step_ms_median=step_s * 1e3, steps_timed=len(timed),
         step_ms_window_medians=[statistics.median(s) * 1e3 for s in windows[1:]],
         step_ms_min=min(timed) * 1e3, step_ms_max=max(timed) * 1e3,
         audio_s_per_s=B * L / 16000 / step_s, layers_ms=layers,
         device_busy_ms=busy_ms,
         device_idle_share=None if busy_ms is None else 1.0 - busy_ms / (step_s * 1e3),
         device_kernels_per_step=n_launches, top_device_ms=top, **cmp)

    # ---- 5. sweep cases ----
    srng = np.random.default_rng(0)
    xs_s = sweep_input(8, 6000, 16000, 140.0, srng)
    l_s = np.full(8, 6000, np.int32)
    l_s[1] = 6000 - 700
    xs22s = sweep_input(8, 8270, 22050, 150.0, srng)
    l22s = np.full(8, 8270, np.int32)
    l22s[1] = 8270 - 900
    for label, cfg, x_np, l_np, r in (
        ("mono-0.7x", cfg16, xs_s, l_s, 0.7),
        ("mono-22k-3.0x", cfg22, xs22s, l22s, 3.0),
    ):
        x_t = torch.as_tensor(x_np, device=dev)
        l_t = torch.as_tensor(l_np, device=dev)
        kernels.reset_launches()
        out = batch.batched_nonlinear_speedup(x_t, l_t, cfg, r, 1.0, 0.1)
        torch.cuda.synchronize()
        swept = dict(kernels.LAUNCHES)
        check(all(swept[k] > 0 for k in BATCH_KERNELS) and swept["gather_rows"] == 0,
              label, "skipped a kernel or left its route", swept)
        check(bool((out.valid_length > 0).all()), label, "empty output")
        check(bool(torch.isfinite(out.output).all()), label, "non-finite output")
        cmp = compare_paths(batch, kernels, x_t, l_t, None, cfg, r, None, out, label)
        emit("sweep", case=label, launches=swept,
             checksum=float(out.output.double().sum()), **cmp)

    # ---- 6. the single-utterance grid pipeline ----
    l_nl, res_nl = path_launches(kernels, lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev))
    check(l_nl["gather_rows"] >= 1 and l_nl["pitch_ssd"] >= 1,
          "single nonlinear skipped a kernel", l_nl)
    check(l_nl["gather_synth"] == 0 and l_nl["analysis_energy_lsd"] == 0,
          "single nonlinear left its route", l_nl)
    check(np.all(np.isfinite(res_nl.output)) and res_nl.tension.shape[0] > 0,
          "single nonlinear output")
    l_pl, plain_nl = path_launches(kernels, lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev, reference=True))
    check(not any(l_pl.values()), "the plain path launched a kernel", l_pl)
    cmp = compare_single(kernels, testutil, wsola_fast, x60, cfg16, res_nl, plain_nl,
                         "single nonlinear", dev)
    wall = single_split_ms(x60, cfg16, 3.5, dev)
    emit("single", case="nonlinear 16kHz 60s 3.5x", launches=l_nl,
         achieved_rate=res_nl.achieved_rate, wall_ms=wall,
         audio_s_per_s=60.0 / (wall["call"] / 1e3), tension_frames=len(res_nl.tension),
         checksum=float(res_nl.output.astype(np.float64).sum()), **cmp)

    x44 = bench_families(30 * 44100, 44100)[0]
    l_li, res_li = path_launches(kernels, lambda: pipeline.linear_time_scale(
        x44, cfg44, 2.0, engine="grid", device=dev))
    check(l_li["gather_rows"] >= 1 and l_li["pitch_ssd"] >= 1
          and l_li["gather_synth"] == 0, "single linear route", l_li)
    plain_li = pipeline.linear_time_scale(x44, cfg44, 2.0, engine="grid", device=dev,
                                          reference=True)
    cmp = compare_single(kernels, testutil, wsola_fast, x44, cfg44, res_li, plain_li,
                         "single linear", dev)
    # 1.0x pass-through: the int16 input back within 1 LSB
    # (tests/test_wsola.py:122-127).
    x44i = np.clip(np.round(x44 * 32768.0), -32768, 32767).astype(np.int16)
    same = pipeline.linear_time_scale(x44i, cfg44, 1.0, engine="grid", device=dev).output
    check(same.shape == x44i.shape, "pass-through length", same.shape)
    lsb = int(np.abs(same.astype(np.int32) - x44i.astype(np.int32)).max())
    check(lsb <= 1, "pass-through off by", lsb)
    emit("single", case="linear 44.1kHz 30s 2.0x", launches=l_li,
         achieved_rate=res_li.achieved_rate,
         wall_ms=host_ms(lambda: pipeline.linear_time_scale(
             x44, cfg44, 2.0, engine="grid", device=dev)),
         passthrough_1x_max_lsb=lsb, **cmp)

    # A speed ceiling routes synthesis to kernel 3; without one, kernel 4.
    speeds = torch.as_tensor(res_nl.speeds, device=dev)
    check(float(speeds.max()) < 6.6, "speeds above the ceiling", float(speeds.max()))
    msb = max(0.01, float(speeds.min()) * 0.999)
    l_b, r_b = path_launches(kernels, lambda: wsola_fast.time_scale_grid(
        x60, speeds, cfg16, min_speed_bound=msb, max_speed_bound=6.6, device=dev))
    l_u, r_u = path_launches(kernels, lambda: wsola_fast.time_scale_grid(
        x60, speeds, cfg16, min_speed_bound=msb, device=dev))
    check(l_b["gather_synth"] >= 1 and l_b["gather_rows"] == 0, "bounded route", l_b)
    check(l_u["gather_rows"] >= 1 and l_u["gather_synth"] == 0, "unbounded route", l_u)
    check(int(r_b.valid_length) == int(r_u.valid_length), "bounded valid_length")
    d_b = float((r_b.output - r_u.output).abs().max())
    check(d_b < 1e-6, "bounded against unbounded", d_b)
    emit("single", case="bounded 16kHz 60s, the 3.5x run's speeds, ceiling 6.6",
         launches_bounded=l_b, launches_unbounded=l_u, valid_length=int(r_b.valid_length),
         max_abs_err=d_b)

    # ---- 7. the CLI ----
    emit("cli", **run_cli_phase(pipeline, wave, cfg16,
                                bench_families(20 * 16000, 16000)[0], dev))

    # Launches: the batched path's run for its kernels, the single
    # nonlinear run for kernel 4.
    launches["gather_rows"] = l_nl["gather_rows"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": results[name][0],
         "ms": results[name][1], "plain_ms": results[name][2]}
        for name, (src, tpu) in KERNEL_SOURCES.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def device_profile(fn):
    """Device time of one call of fn under torch.profiler: the summed
    kernel time in ms, the number of device kernels, and the eight largest
    kernels by time; (None, 0, []) when the profiler saw no device work
    (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None, 0, []
    ms = [e.time_range.elapsed_us() / 1e3 for e in events]
    by_name = {}
    for e, t in zip(events, ms):
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(ms), len(events), [[name[:80], t] for name, t in top]


def layer_times(batch, kernels, engine, xs, lengths, gain, cfg, rate):
    """Median device ms of each layer of one main-path step at its real
    inputs: analysis (kernel 1 and the [B, T] tension code), speed law,
    pitch (kernel 2), synthesis (kernel 3), and the rest of the grid
    engine (time map, phase snap, controls), as the engine's time less the
    two kernels'."""
    import torch
    from speedy_tpu_torch.ops import speed, wsola_fast

    tables = engine.tables()
    B, L = xs.shape
    T = cfg.num_frames(L, integer_step=True)
    tension = batch.batched_analysis(xs, cfg, T, gain, tables)
    speeds = speed.speed_from_tension_parallel(tension, rate, 0.1, 1.0)
    res = engine(xs, lengths, gain)
    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    hop = wsola_fast.default_hop(cfg)
    G = wsola_fast.pitch_grid_stride(cfg)
    n_grid = -(-(L + 2 * maxp) // G)
    capacity = res.output.shape[1]
    K = capacity // hop + 1
    corr = tuple(tables[k] for k in CORR)
    grid = kernels.pitch_ssd(xs, gain, maxp, minp, maxp, G, n_grid, corr)
    a = torch.linspace(0, L - 1, K, device=xs.device)[None].expand(B, K)
    a_i = torch.floor(a).to(torch.int32).contiguous()
    a_f = (a - a_i).contiguous()

    def engine_step():
        return wsola_fast.wsola_grid_batch(
            xs, lengths, res.speeds, minp, maxp, cfg.frame_step_int, hop, capacity,
            K, tables["cola"], corr, max_speed_plan=batch._plan_max_speed(rate, 1.0),
            gain=gain,
        )

    out = {
        "analysis": time_ms(lambda: batch.batched_analysis(xs, cfg, T, gain, tables)),
        "analysis_kernel": time_ms(lambda: kernels.analysis_energy_lsd(
            xs, gain, tables["hamming"], tables["dft_cos"], tables["dft_sin"],
            tables["tw_cos"], tables["tw_sin"], T, cfg.frame_step_int)),
        "speed_law": time_ms(
            lambda: speed.speed_from_tension_parallel(tension, rate, 0.1, 1.0)),
        "grid_engine": time_ms(engine_step),
        "pitch_kernel": time_ms(
            lambda: kernels.pitch_ssd(xs, gain, maxp, minp, maxp, G, n_grid, corr)),
        "synth_kernel": time_ms(lambda: kernels.gather_synth(
            xs, a_i, a_f, tables["cola"], gain, res.valid_length, hop, capacity)),
        "step": time_ms(lambda: engine(xs, lengths, gain)),
    }
    out["time_map_phase_snap_rest"] = (
        out["grid_engine"] - out["pitch_kernel"] - out["synth_kernel"]
    )
    del speeds, grid
    return out


if __name__ == "__main__":
    sys.exit(main())
