#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Builds the port's CUDA kernels from speedy_tpu_torch/csrc with nvcc and
checks them and the port's paths on the card. It times kernels only, for
the table of kernels; the benchmark (portbench/) times the paths. Its
inputs are the benchmark's four families (portbench/traffic_gen.py), and
kernels 1 and 2's bounds are the benchmark's (portbench/roofline.py).

Each kernel is held against its plain PyTorch version on the card, with
its times (kernels 1 and 2 at 16 kHz B=128, 22.05 kHz B=8 and 44.1 kHz
B=32 x 10 s, kernel 1 also at the other sample rates; kernel 3 bitwise to
its plain version and to ops/synth_model.py's model of its plan at hops
160 (B=128), 220, 441, 110 and 480, on one 60 s row and on edge cases;
the row gathers 4-8 also against each other, at the grid engine's shape
B=128 x 10 s at 16 kHz, K=1,009 rows of 321). The port's paths are each
held against the same call through the plain versions, with their
launches:
  - the batched path (SpeedupEngine: B=128 utterances of 10 s at 16 kHz,
    3.5x, capacity factor 1.33, per-utterance gain), its graphed step
    against its eager step, then the dryrun sweep cases (0.7x with a
    ragged length; 22.05 kHz 3.0x), then B=32 x 10 s at 44.1 kHz, 3.5x,
    capacity factor 1.33;
  - the single-utterance grid pipeline (pipeline.nonlinear_speedup on 60 s
    at 16 kHz, 3.5x; linear_time_scale at 44.1 kHz, 2.0x and the 1.0x
    pass-through; time_scale_grid with a speed ceiling against without
    one), and its CLI in a subprocess against the same call in process,
    with the subprocess's wall seconds (start-up included);
  - the sequential speed law's kernel (csrc/speed_law.cu), bitwise equal
    to its plain loop on the card for the 60 s call's tension, the 0.7x
    sweep's batch, seeded [128, 999] tension at 3 rates x 2 feedbacks x 2
    nonlinear factors, and carried-in durations; its event, profiler and
    plain-loop times;
  - the block-span synthesis route (kernel 5) against kernel 3 on the
    bounded 60 s run's chunk positions and on the batch step's, with both
    routes' times;
  - the experiment probes (speedy_tpu_torch/experiments: kernels 9-15),
    each probe's question once through its kernel, then the kernel
    against its plain version and the library call, then its times
    (kernels 13 and 15 in pairs with their library calls, with each one's
    host cost of a launch; kernels 12 and 14 beside the card's floor for
    one launch, a one-element fill_ timed in the same process; kernel 15's
    dot forms also on a seeded normal E, within the float32 bound of their
    products); the bisection probes (kernels 10, 11, 14) time each stage
    of kernels 5 and 3's bodies and hold the last stage to kernels 5 and 3,
    and kernel 14 is also held at every mode on an x2 that is not 16-byte
    aligned; where there is a second card, a launch on a tensor there
    while the first is current.
Prints one line per phase, a JSON line of the kernels' launches, errors,
times and bounds, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failed check raises, so the exit code
is non-zero and no result line is printed. Imports neither JAX, nor the
JAX package, nor its tests.
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
    "gather_rows_block": ("speedy_tpu_torch/csrc/gather_block.cu",
                          "speedy_tpu/ops/pallas_kernels.py:980"),
    "gather_rows_pipelined": ("speedy_tpu_torch/csrc/gather_pipelined.cu",
                              "speedy_tpu/ops/pallas_kernels.py:288"),
    "gather_rows_coalesced": ("speedy_tpu_torch/csrc/gather_coalesced.cu",
                              "speedy_tpu/ops/pallas_coalesced.py:102"),
    "gather_rows_block_v2": ("speedy_tpu_torch/csrc/gather_block.cu",
                             "experiments/gather_v2.py:75"),
    "bf16_split_matmul": ("speedy_tpu_torch/csrc/bf16_split.cu",
                          "experiments/bf16_split_probe.py:70"),
    "gather_bisect": ("speedy_tpu_torch/csrc/gather_bisect.cu",
                      "experiments/gather_bisect.py:62"),
    "synth_bisect": ("speedy_tpu_torch/csrc/synth_bisect.cu",
                     "experiments/synth_bisect.py:24"),
    "narrow_operand_sum": ("speedy_tpu_torch/csrc/narrow_operands.cu",
                           "experiments/lane1_blockspec_probe.py:21"),
    "lane_roll": ("speedy_tpu_torch/csrc/lane_roll.cu",
                  "experiments/multitile_roll_probe.py:26"),
    "bisect_span_rows": ("speedy_tpu_torch/csrc/gather_bisect.cu",
                         "experiments/bisect_kernel.py:57"),
    "transpose_cols": ("speedy_tpu_torch/csrc/transpose.cu",
                       "experiments/mosaic_transpose_probe.py:23"),
    # No Pallas kernel: the JAX package's jitted lax.scan of the law.
    "speed_law": ("speedy_tpu_torch/csrc/speed_law.cu", "speedy_tpu/ops/speed.py:49"),
}
# The probes' kernels and the speedy_tpu_torch/experiments module that
# runs each; no user path launches them.
PROBE_KERNELS = {
    "bf16_split_matmul": "bf16_split_probe",
    "gather_bisect": "gather_bisect",
    "synth_bisect": "synth_bisect",
    "narrow_operand_sum": "lane1_blockspec_probe",
    "lane_roll": "multitile_roll_probe",
    "bisect_span_rows": "bisect_kernel",
    "transpose_cols": "mosaic_transpose_probe",
}
# Kernels a probe launches besides its own: gather_bisect holds its full
# stage to kernel 5, the production function it stops.
PROBE_ORACLES = {"gather_bisect": ("gather_rows_block",)}
# The batched path's kernels (and the sequential speed law at or below
# 1x); the single-utterance nonlinear path's, and its grid engine's alone
# (linear_time_scale and time_scale_grid run no speed law).
BATCH_KERNELS = ("analysis_energy_lsd", "pitch_ssd", "gather_synth")
SLOW_BATCH_KERNELS = (*BATCH_KERNELS, "speed_law")
# The engine's CUDA graphs of its op chains (parallel/graphs.py).
GRAPH_CHAINS = ("tension", "law", "grid")
SINGLE_KERNELS = ("pitch_ssd", "gather_rows", "speed_law")
SINGLE_ENGINE_KERNELS = ("pitch_ssd", "gather_rows")
# The H100 SXM's tensor cores' dense bf16 FLOP/s (NVIDIA data sheet); its
# HBM3 bytes/s and float32 FLOP/s are portbench/roofline.py's.
BF16_FLOP_PER_S = 989e12
CORR = ("pitch_ea", "pitch_es", "pitch_inv", "pitch_band")


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
    """[4, L] float32: the benchmark's four synthetic families
    (portbench/traffic_gen.py::families, which imports torch)."""
    from portbench import traffic_gen

    return traffic_gen.families(L, sr, seed)


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


def assert_period_flips_are_ties(segs, per_a, per_b, taps, minp, maxp,
                                 rel_tol=1e-4, max_flip_frac=0.02):
    """Every cell where two pitch grids part by more than half a sample is a
    float64 SSD tie: the exact objective SSD(d) = sum((seg[:taps] -
    seg[d:d+taps])**2) at both chosen lags agrees within rel_tol of the
    curve's scale, and such cells are at most max_flip_frac of all
    (copied from tests/testutil.py::assert_period_flips_are_ties, which is
    numpy-only; the smoke run imports nothing of the tests)."""
    per_a = np.asarray(per_a, np.float64)
    per_b = np.asarray(per_b, np.float64)
    flips = np.argwhere(np.abs(per_a - per_b) > 0.5)
    check(flips.shape[0] <= max(1, int(max_flip_frac * per_a.size)),
          "too many integer period flips", flips.shape[0], per_a.size)
    lags = np.arange(minp, maxp + 1)
    for b, g in flips:
        seg = np.asarray(segs[b, g][: taps + maxp], np.float64)

        def ssd(lag):
            i = int(round(float(lag)))
            return float(np.sum((seg[:taps] - seg[i : i + taps]) ** 2))

        scale = max(max(ssd(l) for l in lags), 1e-30)
        margin = abs(ssd(per_a[b, g]) - ssd(per_b[b, g])) / scale
        check(margin < rel_tol, "period flip is not an SSD tie", int(b), int(g),
              float(per_a[b, g]), float(per_b[b, g]), margin)


def bound(nbytes: float, flops: float = 0.0, flop_per_s=None):
    """The least time the card could take for work that moves nbytes and
    does flops operations at flop_per_s (float32 by default): (ms, "bytes"
    or "operations")."""
    from portbench.roofline import F32_FLOP_PER_S, HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / (flop_per_s or F32_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def covered_samples(starts, width, live, L) -> int:
    """How many distinct samples of x [B, L] the windows [s, s + width) of
    the live rows cover (clipped to [0, L)): what a gather must read."""
    import torch

    s = starts.long()
    one = live.to(torch.int32)
    d = torch.zeros(starts.shape[0], L + 1, dtype=torch.int32, device=starts.device)
    d.scatter_add_(1, s.clamp(0, L), one)
    d.scatter_add_(1, (s + width).clamp(0, L), -one)
    return int((d.cumsum(1)[:, :L] > 0).sum())


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def hold_energy_lsd(e_k, l_k, e_p, l_p, x, cfg, label, edge_frames=False):
    """Kernel 1's energy and lsd [B, T] (numpy) against a reference's, for
    x [B, L]: energy within 1e-6 + 1e-5 relative; lsd per utterance at most
    2 frames beyond 2e-4 of its scale and relative error below 1e-2, or,
    with edge_frames, each frame at or above 1e-2 a 40 dB mask-edge frame
    (mask_edge_margins below 1e-4: a bin flips in or out of the masked
    sum). Returns the energy's largest error, its largest relative error,
    lsd's errors, the most frames an utterance has beyond 2e-4 of its
    scale, and the mask-edge frames."""
    check(np.all(np.isfinite(e_k)) and np.all(np.isfinite(l_k)), label, "non-finite")
    e_err = np.abs(e_k - e_p)
    e_rel = float((e_err / (np.abs(e_p) + 1e-6)).max())
    check(np.all(e_err <= 1e-6 + 1e-5 * np.abs(e_p)), label, "energy", e_rel)
    # lsd[:, 0] is don't-care. Per utterance at most 2 frames beyond
    # 2e-4*max(scale, 1), and relative error below 1e-2 everywhere
    # (tests/test_pallas_kernels.py:506-511).
    dl = np.abs(l_k[:, 1:] - l_p[:, 1:])
    worst_frames, worst_rel, edges = 0, 0.0, 0
    for b in range(x.shape[0]):
        scale = float(np.abs(l_p[b]).max())
        n_out = int((dl[b] > 2e-4 * max(scale, 1.0)).sum())
        rel = dl[b] / (np.abs(l_p[b, 1:]) + 1.0)
        if edge_frames:
            for t in np.flatnonzero(rel >= 1e-2) + 1:
                m = mask_edge_margins(x[b].cpu().numpy(), cfg, [int(t)])[0]
                check(m < 1e-4, label, "lsd outlier not at a mask edge", b, int(t), m)
                edges += 1
            rel = np.where(rel >= 1e-2, 0.0, rel)
        worst_frames, worst_rel = max(worst_frames, n_out), max(worst_rel, float(rel.max()))
    check(worst_frames <= 2 and worst_rel < 1e-2, label, "lsd", worst_frames, worst_rel)
    return e_err, e_rel, dl, worst_frames, edges


def check_analysis(kernels, batch, x, gain, cfg, label, edge_frames=False):
    """Kernel 1 on the arguments batch.batched_analysis passes it for x
    [B, L] (so any checkout's tables and signature), against its plain
    version with hold_energy_lsd's tolerances. Its CUDA-event and device
    times, the plain version's, the transform alone by torch.fft.rfft, and
    its bound (portbench/roofline.py::analysis_bound_s)."""
    import torch
    from portbench.roofline import F32_FLOP_PER_S, analysis_bound_s
    from speedy_tpu_torch.ops import analysis_fft

    T = cfg.num_frames(x.shape[1], integer_step=True)
    args = recorded_call(kernels, "analysis_energy_lsd",
                         lambda: batch.batched_analysis(x, cfg, T, gain))
    e_k, l_k = kernels.analysis_energy_lsd(*args)
    e_p, l_p = kernels.analysis_energy_lsd_reference(*args)
    torch.cuda.synchronize()
    e_k, l_k, e_p, l_p = (t.cpu().numpy() for t in (e_k, l_k, e_p, l_p))
    e_err, _, dl, worst_frames, edges = hold_energy_lsd(
        e_k, l_k, e_p, l_p, x, cfg, label, edge_frames)
    call = lambda: kernels.analysis_energy_lsd(*args)
    ms = time_ms(call)
    device_ms = device_profile(call)
    plain_ms = time_ms(lambda: kernels.analysis_energy_lsd_reference(*args))
    # The transform alone, not the kernel's function: torch.fft.rfft of the
    # frames, materialized beforehand, at n = 2W, and its magnitude.
    B, L = x.shape
    W, step = cfg.window_size, cfg.frame_step_int
    frames = x.unfold(1, W, step)[:, :T].contiguous()
    library_transform_ms = time_ms(lambda: torch.fft.rfft(frames, n=2 * W).abs())
    del frames
    err = float(e_err.max())
    bound_ms = analysis_bound_s(B, L, W, T) * 1e3
    # The floor of any direct sum: its 2*W*(W-1) FMAs a frame at the
    # float32 peak.
    direct_sum_floor_ms = 4.0 * W * (W - 1) * B * T / F32_FLOP_PER_S * 1e3
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  library_ms=None, device_ms=device_ms,
                  library_transform_ms=library_transform_ms)
    # Where the plan runs the direct sum: the share of its floor the kernel
    # reaches, and whether a pair of bins reads one twiddle (the table
    # mirrored) or two (own entries; None for a plan without the choice).
    plan = analysis_fft.fft_plan(W)
    direct = {}
    if plan.route == "direct":
        mirrored = getattr(plan, "mirrored", None)
        direct = dict(floor_share=None if device_ms is None else direct_sum_floor_ms / device_ms,
                      pairing=None if mirrored is None else
                      ("mirrored" if mirrored else "own entries"))
    emit("kernel", kernel="analysis_energy_lsd", shape=label, frames=B * T,
         energy_max_abs_err=err, lsd_max_abs_err=float(dl.max()),
         lsd_frames_out_max=worst_frames, lsd_mask_edge_frames=edges,
         direct_sum_floor_ms=direct_sum_floor_ms, **direct, **result)
    return result


def short_input(sr: int, dev):
    """2 s of the first two families at sr, [2, 2*sr] on dev: kernel 1's
    input at the rates beside the front-end shapes."""
    import torch

    return torch.as_tensor(batch_of(bench_families(2 * sr, sr), 2), device=dev)


def check_pitch(kernels, x, gain, tables, cfg, label):
    """Kernel 2 against its plain version and the float64 search on x [B,
    L]; its CUDA-event and device times, the plain version's, and its bound
    (portbench/roofline.py::pitch_bound_s)."""
    import torch
    from portbench.roofline import F32_FLOP_PER_S, pitch_bound_s
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
    assert_period_flips_are_ties(segs, per_p, per_k, taps, minp, maxp)
    call = lambda: kernels.pitch_ssd(*args)
    ms = time_ms(call)
    device_ms = device_profile(call)
    plain_ms = time_ms(lambda: kernels.pitch_ssd_reference(*args))
    err = float(d.max())
    bound_ms = pitch_bound_s(B, L, taps, minp, maxp, n_grid) * 1e3
    # The floor of the direct sums: taps FMAs a lag at the float32 peak.
    direct_sum_floor_ms = 2.0 * taps * (maxp - minp + 1) * B * n_grid / F32_FLOP_PER_S * 1e3
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  library_ms=None, device_ms=device_ms,
                  integer_flips=int(flips.sum()),
                  kernel_share_off_f64_0p1=float(np.mean(dk > 0.1)))
    emit("kernel", kernel="pitch_ssd", shape=label, G=G, cells=B * n_grid,
         direct_sum_floor_ms=direct_sum_floor_ms, share_off_0p1_same_lag=share,
         plain_share_off_f64_0p1=float(np.mean(dp > 0.1)),
         kernel_max_off_f64=float(dk.max()), plain_max_off_f64=float(dp.max()),
         **result)
    return result


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


def check_synth(kernels, synth_model, x, gain, hop, K, rate, label, valid=None, a_i=None):
    """Kernel 3 on x [B, L] at chunk positions from synth_case (or a_i, and
    valid, where given), held bitwise (torch.equal) to its plain version
    and to synth_model's float32 model of its plan; its events ms, device
    ms (torch.profiler), plain ms, byte bound and the share of the bound it
    reaches."""
    import torch
    from speedy_tpu_torch.ops.wsola_fast import _cola_hann

    B, L = x.shape
    case_i, a_f, case_valid, capacity = synth_case(B, L, hop, K, rate, 11, x.device)
    a_i = case_i if a_i is None else a_i
    valid = case_valid if valid is None else torch.as_tensor(
        np.asarray(valid, np.int32), device=x.device)
    win = torch.as_tensor(_cola_hann(2 * hop), device=x.device)
    args = (x, a_i, a_f, win, gain, valid, hop, capacity)
    out_k = kernels.gather_synth(*args)
    out_p = kernels.gather_synth_reference(*args)
    out_m = synth_model.gather_synth_model(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(bool(torch.isfinite(out_k).all()), label, "non-finite")
    check(torch.equal(out_k, out_p), label, "kernel 3 differs from its plain version", err)
    check(torch.equal(out_k, out_m), label, "kernel 3 differs from its plan's model",
          float((out_k - out_m).abs().max()))
    call = lambda: kernels.gather_synth(*args)
    ms = time_ms(call)
    device_ms = device_profile(call)
    plain_ms = time_ms(lambda: kernels.gather_synth_reference(*args))
    # The output written once; read once: the 2*hop + 1 samples of every
    # chunk that feeds a valid output slot, and the controls.
    live = torch.arange(K, device=x.device)[None, :] * hop < valid[:, None]
    nbytes = 4 * (B * capacity + covered_samples(a_i, 2 * hop + 1, live, L)
                  + 2 * B * K + 2 * hop + 2 * B)
    bound_ms, bound_by = bound(nbytes)
    plan = synth_model.synth_plan(B, hop, capacity)
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=None, device_ms=device_ms,
                  bound_share=None if device_ms is None else bound_ms / device_ms)
    emit("kernel", kernel="gather_synth", shape=label, run=plan.run, blocks=B * plan.runs,
         threads=plan.threads, bitwise=True, bytes=nbytes, **result)
    return result


def synth_phase(kernels, synth_model, inputs, x60, dev) -> dict:
    """Kernel 3 at the batch step's shape (16 kHz B=128, hop 160, K=383), at
    22.05 and 44.1 kHz (hops 220 and 441), at hops 110 and 480 (11.025 and
    48 kHz, B=8 x 10 s), on one 60 s row at 16 kHz (B=1, as the single
    bounded call launches it), and on edge cases: rows with valid 0, cut inside a run
    and equal to capacity; chunk starts at 0 and clipped to L-1 on short
    rows (reads past the end); a row whose every start is -1 (reads before
    the start). Shape label -> result."""
    import torch

    (_, xs16, gain16), (_, xs22, gain22) = inputs["16kHz"], inputs["22.05kHz"]
    _, xs44, _ = inputs["44.1kHz"]
    rows = {}
    rows["hop=160 B=128 K=383"] = check_synth(
        kernels, synth_model, xs16, gain16, 160, 383, 3.5, "hop=160 B=128 K=383")
    rows["hop=220 B=8 K=400"] = check_synth(
        kernels, synth_model, xs22, gain22, 220, 400, 3.0, "hop=220 B=8 K=400")
    rows["hop=441 B=4 K=400"] = check_synth(
        kernels, synth_model, xs44[:4].contiguous(), gain22[:4].contiguous(), 441, 400, 3.0,
        "hop=441 B=4 K=400")
    for sr in (11025, 48000):
        hop = sr // 100
        x = torch.as_tensor(batch_of(bench_families(10 * sr, sr), 8), device=dev)
        label = f"hop={hop} B=8 K=400"
        rows[label] = check_synth(kernels, synth_model, x, gain22, hop, 400, 3.0, label)
    x1 = torch.as_tensor(x60, device=dev)[None]
    rows["hop=160 B=1 60s K=1715"] = check_synth(
        kernels, synth_model, x1, gain16[:1].contiguous(), 160, 1715, 3.5,
        "hop=160 B=1 60s K=1715")
    g3 = gain16[:3].contiguous()
    check_synth(kernels, synth_model, xs16[:3].contiguous(), g3, 160, 383, 3.5,
                "valid 0 / cut in a run / capacity", valid=[0, 43 * 160 + 13, 382 * 160])
    for hop in (160, 441):
        L = 40 * hop + 3
        short = xs16[:3, :L].contiguous()
        check_synth(kernels, synth_model, short, g3, hop, 200, 3.5,
                    f"hop={hop} L={L}: starts at 0 and clipped to L-1")
    check_synth(kernels, synth_model, xs16[:2, :20000].contiguous(), gain16[:2].contiguous(),
                160, 100, 3.5, "starts -1 (an empty row's positions)",
                valid=[99 * 160, 99 * 160],
                a_i=torch.full((2, 100), -1, dtype=torch.int32, device=dev))
    return rows


# Rate label -> (sample rate, batch): 10 s utterances of the four families,
# at the first benchmark's batch sizes but 22.05 kHz (PERF.md, Cells).
FRONT_END_SHAPES = {"16kHz": (16000, 128), "22.05kHz": (22050, 8), "44.1kHz": (44100, 32)}
# Kernel 1's FFT body where its teams walk long runs, at windows other than
# 16 kHz's: W = 120 and 720 (teams of two warps) in steps of two frames,
# W = 330 in steps of one. As at the short inputs, an lsd frame may be off
# by a mask-edge flip (PR 20's body flips one at 8 kHz).
LONG_RUN_SHAPES = {"8kHz B=64": (8000, 64), "22.05kHz B=64": (22050, 64),
                   "48kHz B=64": (48000, 64)}


def front_end_inputs(dev, rng, shapes=FRONT_END_SHAPES) -> dict:
    """Label -> (cfg, xs [B, 10 s] of the four families, gains drawn
    uniform in [0.5, 1) from rng in the order of shapes, label -> (rate,
    B))."""
    import torch
    from speedy_tpu_torch.config import SpeedyConfig

    out = {}
    for label, (sr, B) in shapes.items():
        xs = torch.as_tensor(batch_of(bench_families(10 * sr, sr), B), device=dev)
        gain = torch.as_tensor(rng.uniform(0.5, 1.0, B).astype(np.float32), device=dev)
        out[label] = (SpeedyConfig(sr), xs, gain)
    return out


def front_end_phase(kernels, batch, inputs, x60) -> dict:
    """Kernels 1 and 2 against their plain versions at each shape of
    front_end_inputs, and kernel 2 also on the 60 s single call's input
    x60 (16 kHz, gain 1). Returns {kernel: {shape label: result}}."""
    import torch

    rows = {"analysis_energy_lsd": {}, "pitch_ssd": {}}
    for label, (cfg, xs, gain) in inputs.items():
        rows["analysis_energy_lsd"][label] = check_analysis(
            kernels, batch, xs, gain, cfg, f"{label} B={xs.shape[0]} L={xs.shape[1]}")
        rows["pitch_ssd"][label] = check_pitch(
            kernels, xs, gain, batch.device_tables(cfg, xs.device), cfg,
            f"{label} B={xs.shape[0]} L={xs.shape[1]}")
    cfg, xs, _ = inputs["16kHz"]
    x = torch.as_tensor(x60, device=xs.device)[None]
    rows["pitch_ssd"]["16kHz 60s"] = check_pitch(
        kernels, x, torch.ones(1, device=xs.device), batch.device_tables(cfg, xs.device),
        cfg, f"16kHz B=1 L={x.shape[1]} (the single call)")
    return rows


def check_analysis_model(kernels, batch, analysis_fft, inputs) -> dict:
    """Kernel 1 against analysis_fft.spectrum_model, the float32 model of
    its FFT's stages in their order, at each shape of front_end_inputs
    whose plan is the FFT: the model's magnitudes through the plain
    version's framing and reductions (kernels.windowed_frames,
    kernels.energy_lsd), held with hold_energy_lsd's tolerances. Returns
    {shape label: the energy's and lsd's largest errors}."""
    import torch

    out = {}
    for label, (cfg, x, gain) in inputs.items():
        W = cfg.window_size
        if analysis_fft.fft_plan(W).route != "stockham":
            continue
        T = cfg.num_frames(x.shape[1], integer_step=True)
        args = recorded_call(kernels, "analysis_energy_lsd",
                             lambda: batch.batched_analysis(x, cfg, T, gain))
        x_, gain_, ham, _, _, _, T_, step = args
        e_k, l_k = kernels.analysis_energy_lsd(*args)
        frames = kernels.windowed_frames(x_, gain_, ham, T_, step)
        half = analysis_fft.spectrum_model(frames.reshape(-1, W)).reshape(frames.shape)
        e_m, l_m = kernels.energy_lsd(half)
        torch.cuda.synchronize()
        del frames, half
        e_k, l_k, e_m, l_m = (t.cpu().numpy() for t in (e_k, l_k, e_m, l_m))
        tag = f"{label} B={x.shape[0]} against spectrum_model"
        e_err, e_rel, dl, worst_frames, _ = hold_energy_lsd(e_k, l_k, e_m, l_m, x, cfg, tag)
        out[label] = dict(energy_max_abs_err=float(e_err.max()), energy_max_rel_err=e_rel,
                          lsd_max_abs_err=float(dl.max()), lsd_frames_out_max=worst_frames)
        emit("kernel_model", kernel="analysis_energy_lsd", shape=label, **out[label])
    return out


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path against the plain path
# ---------------------------------------------------------------------------


def compare_paths(batch, kernels, xs, lengths, gain, cfg, rate, cap_factor, res, label,
                  own_share_gate=True):
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
      - the plain path with its own grid against the plain path fed the
        kernel's (the same tension, so the same speeds): every sample
        differs by no more than the two grids' moves of the chunks that
        feed it explain, and so not at all outside the output slots of
        chunks whose source position the grids move (as
        tests/test_pallas_kernels.py:718-746 traces every sample off by
        more than 1e-3 to a cell whose period differs). A row is the
        gained source's linear interpolant read from a + j, so a chunk
        moved by |da| moves it by at most |da| times the source's largest
        step between neighbours, and a slot's two COLA weights sum to at
        most cw; 1e-5 is left for float32 rounding;
      - with its own grid, under 2% of the valid samples are off by more
        than 1e-3 (tests/test_pallas_kernels.py:750); reported, not gated,
        where own_share_gate is False (the 44.1 kHz batch phase: a chunk's
        position multiplies a period difference by its snap count, and
        the previous bullet holds those moves to the grids)."""
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
    # The own grid's part: the plain path's own grid against the kernel's.
    check(torch.equal(plain.speeds, fed.speeds), label, "plain speeds differ with the grid")
    grid_p = kernels.pitch_ssd_reference(xs, g, maxp, minp, maxp, G, n_grid, corr)
    po = wsola_fast.grid_positions(lens32, plain.speeds, grid_p, cfg.frame_step_int, hop, G,
                                   capacity, K, max_speed_plan=plan)
    da = (pp.a - po.a).abs()
    reach = da.clone()
    reach[:, 1:] = torch.maximum(da[:, 1:], da[:, :-1])  # slot k: chunks k-1 and k
    reach = reach.repeat_interleave(hop, dim=1)[:, :capacity]
    src = torch.nn.functional.pad(xs * g[:, None], (1, 1))
    lip = (src[:, 1:] - src[:, :-1]).abs().amax(dim=1)
    cola = tables["cola"]
    cw = max(float((cola[:hop] + cola[hop:]).max()), 1.0)
    d_grid = (plain.output - fed.output).abs()
    excess = d_grid - reach * lip[:, None] * cw
    n_beyond = int((excess > 1e-5).sum())
    check(n_beyond == 0, label, "own-grid samples beyond their chunks' moves", n_beyond,
          float(excess.max()))
    d_own = (plain.output - res.output).abs()
    valid_total = max(int(res.valid_length.sum()), 1)
    share = float((d_own > 1e-3).sum()) / valid_total
    check(share < 0.02 or not own_share_gate, label, "own-grid share of |d| > 1e-3", share)
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
                own_grid_moved_chunks=int((da > 0).sum()),
                own_grid_move_max=float(da.max()),
                own_grid_max_abs_err=float(d_grid.max()),
                own_grid_share_over_1e3=float((d_grid > 1e-3).sum()) / valid_total,
                own_grid_excess_max=float(excess.max()),
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


def check_gather(kernels, name, label, x, starts, width, n_valid=None, same_as=None, **kw):
    """Gather kernel `name` of kernels.py on (x, starts, width, n_valid) and
    its own arguments kw, run alone: one launch of its kernel and no other;
    rows exactly its plain version's (gather_rows_reference, the zero rows
    past n_valid included) and, where given, same_as (kernel 4's rows);
    median device times of the kernel, the plain version and the library
    call; the bytes it must move and its bound. Returns (result, rows)."""
    import torch

    fn = getattr(kernels, name)
    if n_valid is not None:
        kw["n_valid"] = n_valid
    call = lambda: fn(x, starts, width, **kw)
    launches, rows = path_launches(call)
    check(launches[name] == 1 and sum(launches.values()) == 1, label, name, "launches",
          launches)
    plain = lambda: kernels.gather_rows_reference(x, starts, width, n_valid)
    rows_p = plain()
    torch.cuda.synchronize()
    check(rows.shape == rows_p.shape, label, name, "shape", tuple(rows.shape))
    err = float((rows - rows_p).abs().max())
    check(torch.equal(rows, rows_p), label, name, "rows differ from the plain version", err)
    if same_as is not None:
        check(torch.equal(rows, same_as), label, name, "rows differ from kernel 4's")
    del rows_p
    # The library call: the [B, L - width + 1, width] view unfold gives,
    # indexed by the starts. It clamps nothing (the starts here are in
    # range) and keeps the rows past n_valid.
    B, L = x.shape
    K = starts.shape[1]
    check(int(starts.min()) >= 0 and int(starts.max()) <= L - width, label,
          "starts out of range for the library call")
    view = x.unfold(1, width, 1)
    batch_idx = torch.arange(B, device=x.device)[:, None]
    library = lambda: view[batch_idx, starts]
    live = torch.ones(B, K, dtype=torch.bool, device=x.device)
    if n_valid is not None:
        live = torch.arange(K, device=x.device)[None, :] < n_valid[:, None]
    check(torch.equal(torch.where(live[:, :, None], library(), 0.0), rows), label,
          "library call differs")
    ms, plain_ms, library_ms = time_ms(call), time_ms(plain), time_ms(library)
    nbytes = 4 * (rows.numel() + covered_samples(starts, width, live, L) + starts.numel()
                  + (0 if n_valid is None else B))
    bound_ms, bound_by = bound(nbytes)
    # Device time alone (torch.profiler): a call's CUDA-event time also holds
    # the host's launch path, tens of microseconds for a ctypes launch.
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=library_ms, launches=launches[name],
                  device_ms=device_profile(call),
                  library_device_ms=device_profile(library))
    emit("kernel", kernel=name, shape=label, B=B, K=K, width=width, L=L,
         rows_live=int(live.sum()), bytes=nbytes, **result)
    return result, rows


def gather_phase(kernels, wsola_fast, xs, cfg, ceiling):
    """Kernels 4-8 at the grid engine's own gather shape, "shape A"
    (experiments/gather_v2.py:13-21, 117-120): xs [B, L] padded as the
    unfused synthesis pads it, K rows of 2*hop + 1 whose starts step 3.51
    hops a chunk, clipped to the signal, the first L / 3.51 / hop + 2 of
    them live, R = 128 rows a block and the w_span of the ceiling.
    Kernels 5 and 8 run kernel 4's arguments; kernels 6 and 7 (every row
    live, K a multiple of 8) run at B = 32 and at B. Each is held to its
    plain version and to kernel 4's rows. Returns each kernel's result at
    the full B."""
    import torch

    B, L = xs.shape
    maxp = cfg.wsola_max_period
    hop, _, K = wsola_fast.plan_grid(cfg, L, 1.0)
    width, R = 2 * hop + 1, wsola_fast.SPAN_ROWS
    src = torch.nn.functional.pad(xs, (maxp, 3 * maxp + 2 * hop)).contiguous()
    c = np.cumsum(np.full((B, K), hop * 3.51), axis=1).astype(np.float32)
    starts = torch.as_tensor(np.clip(c.astype(np.int32), 0, L - 1) + maxp, device=xs.device)
    live = int(L / 3.51 / hop) + 2
    n_valid = torch.full((B,), live, dtype=torch.int32, device=xs.device)
    w_span = wsola_fast.span_width(R, hop, ceiling, maxp, width)
    label = f"shape A: 16kHz B={B} K={K} width {width}, {live} live, R={R} w_span={w_span}"
    out = {}
    out["gather_rows"], rows4 = check_gather(kernels, "gather_rows", label, src, starts,
                                             width, n_valid)
    for name in ("gather_rows_block", "gather_rows_block_v2"):
        out[name], _ = check_gather(kernels, name, label, src, starts, width, n_valid,
                                    same_as=rows4, rows_per_block=R, w_span=w_span)
    del rows4
    K8 = K // kernels.COALESCED_ROWS * kernels.COALESCED_ROWS
    for nb in (min(32, B), B):
        x_b, s_b = src[:nb].contiguous(), starts[:nb, :K8].contiguous()
        label = f"16kHz B={nb} K={K8} width {width}, every row live"
        _, rows4 = check_gather(kernels, "gather_rows", label, x_b, s_b, width)
        out["gather_rows_pipelined"], _ = check_gather(
            kernels, "gather_rows_pipelined", label, x_b, s_b, width, same_as=rows4)
        route = torch.full((nb, K8 // 8), -1, dtype=torch.int32, device=xs.device)
        out["gather_rows_coalesced"], _ = check_gather(
            kernels, "gather_rows_coalesced", label, x_b, s_b, width, same_as=rows4,
            span_rows=64, span_route=route)
        want = kernels.coalesced_span_blocks(s_b, width, 64, x_b.shape[1])
        check(torch.equal(route, want.to(torch.int32)), label, "kernel 7's routes",
              int((route != want.to(torch.int32)).sum()))
        share = float(route.float().mean())
        out["gather_rows_coalesced"]["span_route_share"] = share
        emit("kernel_route", kernel="gather_rows_coalesced", shape=label,
             blocks=route.numel(), span_route_share=share)
        del rows4
    return out


def check_gather_edges(kernels, dev):
    """Kernels 4-8 on starts that break the TPU kernels' contracts, each
    exactly equal to the plain version (kernels 6 and 7 on the first
    K // 8 * 8 rows): random starts, negative and past L - width, with
    n_valid of 0 and below, and a w_span of 2,048 that no tile's union
    fits; 44.1 kHz rows of 883 stepping up to 2,867 samples (the 6.5x
    ceiling), whose tile unions overflow the tile buffer; sorted starts
    with R = 5 and no n_valid. Kernel 7's routes equal
    coalesced_span_blocks'."""
    import torch

    rng = np.random.default_rng(3)
    x_r = rng.standard_normal((4, 50000)).astype(np.float32)
    s_r = rng.integers(-1000, 51000, (4, 301))
    x_w = rng.standard_normal((4, 450000)).astype(np.float32)
    s_w = np.minimum(np.cumsum(rng.integers(0, 2867, (4, 150)), axis=1), 450000 - 884)
    cases = {
        "random": (x_r, s_r, 443, [301, 100, 0, -3], 32, 2048),
        "wide": (x_w, s_w, 883, [150, 149, 17, 1], 128, 366592),
        "sorted R=5": (x_r, np.sort(s_r, axis=1), 321, None, 5, 321),
    }
    shares = {}
    for label, (x, s, width, nv, R, w_span) in cases.items():
        x = torch.as_tensor(x, device=dev)
        s = torch.as_tensor(s.astype(np.int32), device=dev)
        nv = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=dev)
        want = kernels.gather_rows_reference(x, s, width, nv)
        got = {"gather_rows": kernels.gather_rows(x, s, width, nv)}
        for name in ("gather_rows_block", "gather_rows_block_v2"):
            got[name] = getattr(kernels, name)(x, s, width, R, w_span, nv)
        for name, rows in got.items():
            check(torch.equal(rows, want), label, name, "rows differ from the plain version")
        K8 = s.shape[1] // kernels.COALESCED_ROWS * kernels.COALESCED_ROWS
        s8 = s[:, :K8].contiguous()
        want = kernels.gather_rows_reference(x, s8, width)
        route = torch.full((s.shape[0], K8 // 8), -1, dtype=torch.int32, device=dev)
        check(torch.equal(kernels.gather_rows_pipelined(x, s8, width), want), label,
              "gather_rows_pipelined rows differ from the plain version")
        check(torch.equal(kernels.gather_rows_coalesced(x, s8, width, 64, route), want), label,
              "gather_rows_coalesced rows differ from the plain version")
        routes = kernels.coalesced_span_blocks(s8, width, 64, x.shape[1]).to(torch.int32)
        check(torch.equal(route, routes), label, "kernel 7's routes")
        shares[label] = float(route.float().mean())
    emit("gather_edges", cases=list(cases), exact=True, coalesced_span_route_share=shares)


def span_route_check(kernels, wsola_fast, tables, xs, lengths, speeds, gain, cfg, capacity,
                     ceiling, label):
    """The block-span synthesis route (wsola_fast._synth_spans: kernel 5,
    then torch) and kernel 3 on the same chunk positions, those the grid
    engine gives xs [B, L] at speeds [B, F] under the ceiling: the span
    route launches kernel 5 and not kernel 3, the two agree within 1e-6;
    both routes' device times. Returns the span route's launches, output
    and valid lengths."""
    import torch

    B, L = xs.shape
    maxp, minp = cfg.wsola_max_period, cfg.wsola_min_period
    hop = wsola_fast.default_hop(cfg)
    G = wsola_fast.pitch_grid_stride(cfg, hop)
    K = capacity // hop + 1
    g = torch.ones(B, device=xs.device) if gain is None else gain
    corr = tuple(tables[k] for k in CORR)
    grid = kernels.pitch_ssd(xs, g, maxp, minp, maxp, G, -(-(L + 2 * maxp) // G), corr)
    pos = wsola_fast.grid_positions(lengths, speeds, grid, cfg.frame_step_int, hop, G,
                                    capacity, K, ceiling)
    a_i = torch.floor(pos.a).to(torch.int32)
    a_f = pos.a - a_i.to(torch.float32)
    cola = tables["cola"]
    spans = lambda: wsola_fast._synth_spans(xs, a_i, a_f, cola, gain, pos.valid, hop,
                                            capacity, maxp, ceiling)
    fused = lambda: kernels.gather_synth(xs, a_i, a_f, cola, g, pos.valid, hop, capacity)
    l_s, y_s = path_launches(spans)
    l_f, y_f = path_launches(fused)
    check(l_s["gather_rows_block"] >= 1 and sum(l_s.values()) == l_s["gather_rows_block"],
          label, "span route launches", l_s)
    check(l_f["gather_synth"] == 1 and sum(l_f.values()) == 1, label, "kernel 3 launches", l_f)
    d = float((y_s - y_f).abs().max())
    check(bool(torch.isfinite(y_s).all()) and d < 1e-6, label, "span route against kernel 3", d)
    w_span = wsola_fast.span_width(wsola_fast.SPAN_ROWS, hop, ceiling, maxp, 2 * hop + 1)
    emit("span_route", case=label, B=B, K=K, w_span=w_span, launches_span=l_s,
         launches_fused=l_f, max_abs_err=d, span_ms=time_ms(spans), fused_ms=time_ms(fused))
    return l_s, y_s, pos.valid


# ---------------------------------------------------------------------------
# The experiment probes: kernels 9-15
# ---------------------------------------------------------------------------


def probe_bound(name: str, row: dict):
    """(bytes, bound ms, "bytes" or "operations") of one probe check row:
    inputs read once and outputs written once, the words the function
    needs; kernel 9's passes of 2*M*N*K over the tensor cores' bf16 peak
    (3 for a split, 1 for default) or, for highest, float32 FMA's. The
    bisection probes count their stage's words from this run's data
    (out_words, read_words: each span sample a stage's output comes from,
    once)."""
    if name in ("gather_bisect", "synth_bisect", "bisect_span_rows"):
        nbytes = 4 * (row["out_words"] + row["read_words"])
        return (nbytes, *bound(nbytes))
    if name == "bf16_split_matmul":
        M, K, N, mode = row["M"], row["K"], row["N"], row["mode"]
        nbytes = 4 * (M * K + K * N + M * N)
        if mode == "highest":
            return (nbytes, *bound(nbytes, 2.0 * M * N * K))
        passes = 1 if mode == "default" else 3
        return (nbytes, *bound(nbytes, passes * 2.0 * M * N * K, BF16_FLOP_PER_S))
    if name == "transpose_cols":
        F, cols = row["F"], 8  # 8 columns in, 8 rows out
        eye_words, flops = {"swap": (0, 0.0), "dot_rhsT": (cols * cols, 2.0 * cols * cols * F),
                            "dot_lhsT": (F * F, 2.0 * cols * F * F)}[row["form"]]
        nbytes = 4 * (2 * cols * F + eye_words)
        return (nbytes, *bound(nbytes, flops))
    if name == "lane_roll":
        nbytes = 4 * 2 * row["R"] * row["G"]
        return (nbytes, *bound(nbytes))
    B, rows = row["shape"][0], 8  # narrow_operand_sum: 3 x 8 words in, 8 out
    nbytes = 4 * (3 * B * rows + B * rows)
    return (nbytes, *bound(nbytes, 3.0 * B * rows))


def probe_headline(name: str, rows: list) -> dict:
    """The check row each probe kernel reports in the kernels line: kernel
    9's conv3 at kernel 1's DFT product, kernel 15's swap form, kernel 12's
    narrow [4096, 1] layout, kernel 13's one row, and the bisection probes'
    last stage (kernel 11's at the 6.0x span)."""
    pick = {
        "bf16_split_matmul": lambda r: r["mode"] == "conv3" and r["case"].startswith("kernel 1"),
        "gather_bisect": lambda r: r["stage"] == "full",
        "synth_bisect": lambda r: r["stage"] == "full" and r["max_speed"] == 6.0,
        "bisect_span_rows": lambda r: r["mode"] == "full",
        "transpose_cols": lambda r: r["form"] == "swap",
        "narrow_operand_sum": lambda r: r["shape"][-1] == 1,
        "lane_roll": lambda r: True,
    }[name]
    return next(r for r in rows if pick(r))


def probe_phase(dev) -> dict:
    """Kernels 9-15 through their experiment entry points: each probe's
    check() with the launch counts set to 0 just before and read just
    after, which must show its kernel and no other (but PROBE_ORACLES'
    production kernel). check() first
    asks the probe's question once through the kernel (its answer pass,
    whose launches each row records), then holds the kernel to its plain
    version and the library call, raising on a difference, then times it.
    Each row gets its bound. Returns per kernel its headline row with the
    launches of the probe's answer passes; emits the phase's wall
    seconds."""
    import importlib

    out = {}
    t0 = time.perf_counter()
    for name, module in PROBE_KERNELS.items():
        mod = importlib.import_module(f"speedy_tpu_torch.experiments.{module}")
        counts, rows = path_launches(lambda: mod.check(dev))
        check(only(counts, (name, *PROBE_ORACLES.get(name, ()))), module, "launches", counts)
        answered = sum(r["launches"] for r in rows)
        check(0 < answered <= counts[name], module, "answer launches", answered, counts)
        for row in rows:
            row["bytes"], row["bound_ms"], row["bound_by"] = probe_bound(name, row)
            emit("probe_check", kernel=name, **row)
        emit("probe", probe=module, kernel=name, launches=answered,
             launches_with_timing=counts[name])
        out[name] = dict(probe_headline(name, rows), launches=answered)
    emit("probes", seconds=time.perf_counter() - t0)
    return out


def check_other_card(kernels) -> dict:
    """A wrapper given a tensor on a card that is not the current one
    launches on that card: kernel 13 on cuda:1 while cuda:0 is current,
    bitwise to torch.roll there, with one launch. Not run with one card."""
    import torch

    if torch.cuda.device_count() < 2:
        return dict(run=False, reason="one card")
    check(torch.cuda.current_device() == 0, "cuda:0 is not the current device")
    x = torch.randn(64, 512, device="cuda:1")
    counts, out = path_launches(lambda: kernels.lane_roll(x, 266))
    torch.cuda.synchronize(1)
    check(out.device == x.device and torch.equal(out, torch.roll(x, 266, 1)),
          "lane_roll on cuda:1")
    check(counts["lane_roll"] == 1 and torch.cuda.current_device() == 0,
          "lane_roll on cuda:1 launches", counts)
    return dict(run=True, device=str(x.device))


def check_bisect_edges(kernels, dev) -> None:
    """Kernels 10, 11 and 14 against their plain versions off the
    experiments' shapes: blocks of 100 rows, K = 300, a dead utterance
    (n_valid 0) and a half-live one, negative starts and starts past L (the
    flat view reads zeros before it, and on into the next utterance or
    zeros past an utterance's end), a span too short for its block (rows
    past w_rows select zeros), hops 100 (one tile, no whole-tile roll) and
    256 (no lane shift), and kernel 14's picks below 0 and past w_rows.
    Bitwise, every kernel at every stage."""
    import torch

    rng = np.random.default_rng(4)
    B, L, K, R = 3, 50000, 300, 100
    x = torch.as_tensor(rng.standard_normal((B, L)).astype(np.float32), device=dev)
    steps = rng.integers(90, 180, (B, K))
    steps[1] = rng.integers(400, 700, K)  # a block spreads past its span; rows run past L
    starts = torch.as_tensor((np.cumsum(steps, axis=1) - 400).astype(np.int32), device=dev)
    af = torch.as_tensor(rng.uniform(0, 1, (B, K)).astype(np.float32), device=dev)
    n_valid = torch.tensor([300, 150, 0], dtype=torch.int32, device=dev)
    worst, cases = 0.0, 0

    def hold(name, got, want):
        nonlocal worst, cases
        d = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.equal(got, want), "bisect edges", name,
              d)
        worst, cases = max(worst, d), cases + 1

    for width, w_span in ((321, 49152), (200, 40960)):
        for stage in kernels.GATHER_BISECT_STAGES:
            kw = dict(width=width, rows_per_block=R, w_span=w_span)
            hold(f"gather_bisect {stage} width {width}",
                 kernels.gather_bisect(x, starts, n_valid, stage, **kw),
                 kernels.gather_bisect_reference(x, starts, n_valid, stage, **kw))
    for hop, w_span in ((100, 12288), (256, 24576)):
        for stage in kernels.SYNTH_BISECT_STAGES:
            kw = dict(hop=hop, rows_per_block=R, w_span=w_span)
            hold(f"synth_bisect {stage} hop {hop}",
                 kernels.synth_bisect(x, starts, af, n_valid, stage, **kw),
                 kernels.synth_bisect_reference(x, starts, af, n_valid, stage, **kw))
    w_rows = 40
    x2 = torch.as_tensor(rng.standard_normal((2 * 100 + 20, 128)).astype(np.float32), device=dev)
    nvb = torch.tensor([2, 1], dtype=torch.int32, device=dev)
    bases = torch.as_tensor(rng.integers(-8, 120, (2, 3)).astype(np.int32), device=dev)
    for R14, modes in ((8, ("dma", "dot", "full", "none")), (12, ("dot", "full"))):
        q8k = torch.as_tensor(rng.integers(-3, w_rows + 3, (2, 3, R14 * 4)).astype(np.int32),
                              device=dev)
        for mode in modes:
            kw = dict(rows_per_block=R14, w_rows=w_rows, nt=4, length_rows=100)
            hold(f"bisect_span_rows {mode} R {R14}",
                 kernels.bisect_span_rows(nvb, bases, q8k, x2, mode, **kw),
                 kernels.bisect_span_rows_reference(nvb, bases, q8k, x2, mode, **kw))
    emit("bisect_edges", cases=cases, max_abs_err=worst)


def check_span_rows_unaligned(kernels, dev) -> None:
    """Kernel 14 on an x2 whose base is 4 bytes past a 16-byte boundary,
    where the kernel makes 4-byte accesses in place of 16-byte ones:
    bitwise to its plain version at every mode, with one launch each, on
    the probe's inputs at R = 16, w_rows = 64."""
    import torch
    from speedy_tpu_torch.experiments import bisect_kernel

    nvb, bases, q8k, x2 = bisect_kernel.inputs(16, 64, dev)
    shifted = torch.empty(x2.numel() + 1, dtype=x2.dtype, device=dev)[1:].view(x2.shape)
    shifted.copy_(x2)
    check(shifted.data_ptr() % 16 == 4, "x2 not shifted", shifted.data_ptr() % 16)
    kw = dict(rows_per_block=16, w_rows=64, nt=bisect_kernel.NT,
              length_rows=bisect_kernel.LENGTH_ROWS)
    for mode in bisect_kernel.MODES:
        counts, got = path_launches(
            lambda: kernels.bisect_span_rows(nvb, bases, q8k, shifted, mode, **kw))
        want = kernels.bisect_span_rows_reference(nvb, bases, q8k, x2, mode, **kw)
        check(counts["bisect_span_rows"] == 1 and torch.equal(got, want),
              "bisect_span_rows unaligned x2", mode, counts["bisect_span_rows"])
    emit("span_rows_unaligned", modes=len(bisect_kernel.MODES), x2_offset_bytes=4)


# ---------------------------------------------------------------------------
# The single-utterance path against the plain path
# ---------------------------------------------------------------------------


def compare_single(kernels, wsola_fast, x, cfg, res, plain, label, dev):
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
    assert_period_flips_are_ties(
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


def only(launches, names) -> bool:
    """Every kernel in names launched, and no other."""
    return all((launches[k] > 0) == (k in names) for k in launches)


def graphed_step(engine, args, eager, label):
    """The engine's third step on args, after its eager first step
    (eager: that step's launch counts, body counts and result) and the
    second, which captures the graphs: the step replays the three graphs,
    captures none, syncs nothing, launches what the eager step launched,
    and gives its result bitwise. Returns the result and trace.GRAPHS."""
    import torch

    from speedy_tpu_torch import trace

    engine(*args)
    torch.cuda.synchronize()
    trace.reset()
    res = engine(*args)
    torch.cuda.synchronize()
    graphs = dict(trace.GRAPHS)
    launches, bodies, want = eager
    check(graphs == {f"{c}:replay": 1 for c in GRAPH_CHAINS}, label,
          "a warm step left its three graphs", graphs)
    check(not trace.SYNCS, label, "a warm step synced", trace.SYNCS)
    check(dict(trace.LAUNCHES) == launches and dict(trace.BODIES) == bodies, label,
          "the graphed step launched other kernels than the eager one",
          trace.LAUNCHES, trace.BODIES)
    check(all(torch.equal(a, b) for a, b in zip(res, want)), label,
          "the graphed step differs from the eager one")
    return res, graphs


def path_launches(run):
    """run() with every launch count set to 0 just before; the counts just
    after, and run()'s result."""
    import torch

    from speedy_tpu_torch import trace

    torch.cuda.synchronize()
    trace.reset()
    out = run()
    torch.cuda.synchronize()
    return dict(trace.LAUNCHES), out


# ---------------------------------------------------------------------------
# The sequential speed law
# ---------------------------------------------------------------------------

# Float32 operations a frame of the law: the base law (3), the feedback
# term (4), the two durations (3, one a division) and the interpolation (2).
LAW_FLOP_PER_FRAME = 12
# The frame-to-frame chain as the kernel runs it: cur + q, cur - des, fb *
# it, the maximum, + base, the reciprocal (MUFU.RCP), the quotient from it,
# its remainder and the corrected quotient (csrc/speed_law.cu's
# law_divide, bitwise IEEE division for the law's numerator): 9 dependent
# float32 operations and a reciprocal, 52 cycles a frame measured on an
# H100 80GB HBM3 at 700 W (law_variants.py at commit c4c951d: clock64
# over 65,536 frames of the chain alone in registers; 68 with __fdiv_rn).
# The least time of a frame, whatever holds its operands.
LAW_CHAIN_CYCLES = 52
LAW_CASES = [(r, fb, nl) for r in (0.7, 1.0, 3.5) for fb in (0.0, 0.1) for nl in (0.5, 1.0)]
# Batch sizes and lengths at the kernel's edges: warps of 8 walkers,
# chunks of 16 frames read ahead, and the parent's blocks of 32 rows and
# chunks of 64 frames.
LAW_EDGE_B = (1, 7, 9, 31, 33, 128)
LAW_EDGE_T = (1, 15, 16, 17, 63, 64, 65, 129, 1000)


def hold_speed_law(kernels, label, tension, rate, fb, nl, durations=None) -> None:
    """kernels.speed_law against its plain loop on the same card inputs:
    speeds and both final durations bitwise equal (torch.equal)."""
    import torch

    got = kernels.speed_law(tension, rate, fb, nl, durations)
    want = kernels.speed_law_reference(tension, rate, fb, nl, durations)
    torch.cuda.synchronize()
    for part, g, w in zip(("speeds", "current", "desired"), (got[0], *got[1]),
                          (want[0], *want[1])):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()), label, part,
              "shape or non-finite", tuple(g.shape))
        check(torch.equal(g, w), label, part, "differs from the plain loop",
              int((g != w).sum()), float((g - w).abs().max()))


def speed_law_phase(kernels, single_args, sweep_args, dev, sm_clock_mhz) -> dict:
    """The speed-law kernel held bitwise to its plain loop on the card: on
    the 60 s single call's own tension and the 0.7x sweep's batch (the
    arguments those runs passed kernels.speed_law), on seeded tension
    [128, 999] at LAW_CASES, with carried-in durations, and at every B of
    LAW_EDGE_B and T of LAW_EDGE_T with carried-in durations; the walk's
    division against IEEE division at every denominator it is proved on
    (kernels.speed_law_division_check, which must find none). Times at the
    single call's tension and at [128, 999], 3.5x: the kernel's CUDA-event
    ms (median of 10), its device ms (torch.profiler), the plain loop's ms
    (one call), the bound of bytes and operations and the chain-latency
    estimate T * LAW_CHAIN_CYCLES at the card's maximum SM clock. Returns
    the single call's row for the kernels line."""
    import torch

    t0 = time.perf_counter()
    hold_speed_law(kernels, "60 s single call", *single_args)
    hold_speed_law(kernels, "0.7x sweep", *sweep_args)
    rng = np.random.default_rng(5)
    seeded = torch.as_tensor((rng.standard_normal((128, 999)) * 0.5).astype(np.float32),
                             device=dev)
    for rate, fb, nl in LAW_CASES:
        hold_speed_law(kernels, f"[128, 999] {rate}x fb {fb} nl {nl}", seeded, rate, fb, nl)
    durations = tuple(torch.as_tensor(rng.uniform(0.0, 4.0, 128).astype(np.float32), device=dev)
                      for _ in range(2))
    for rate in (0.7, 3.5):
        hold_speed_law(kernels, f"[128, 999] {rate}x carried durations", seeded, rate, 0.1,
                       1.0, durations)
    edge = torch.as_tensor((rng.standard_normal((max(LAW_EDGE_B), max(LAW_EDGE_T))) * 0.5)
                           .astype(np.float32), device=dev)
    for B in LAW_EDGE_B:
        for T in LAW_EDGE_T:
            carried = tuple(d[:B].contiguous() for d in durations)
            hold_speed_law(kernels, f"[{B}, {T}] 3.5x carried durations",
                           edge[:B, :T].contiguous(), 3.5, 0.1, 1.0, carried)
    # Tension of -1e38 at 3.5x makes a base speed past 2^126, where the
    # walk's division is not proved: the kernel walks that row again with
    # IEEE division.
    huge = edge[:3, :100].clone()
    huge[1, 50] = -1e38
    hold_speed_law(kernels, "[3, 100] 3.5x, a denominator past 2^126", huge, 3.5, 0.1, 1.0)
    mismatches = kernels.speed_law_division_check(dev)
    lo, hi = kernels.DIVISION_CHECK_RANGE
    check(mismatches == 0, "the walk's division differs from IEEE division at", mismatches,
          "of", hi - lo, "denominators")
    emit("speed_law_division", denominators=hi - lo, mismatches=mismatches)
    rows = {}
    for label, (tension, rate, fb, nl, init) in (
        ("60 s single call", single_args),
        ("[128, 999] 3.5x fb 0.1 nl 1.0", (seeded, 3.5, 0.1, 1.0, None)),
    ):
        B, T = tension.shape
        call = lambda: kernels.speed_law(tension, rate, fb, nl, init)
        ms = time_ms(call)
        device_ms = device_profile(call)
        plain_ms = time_ms(lambda: kernels.speed_law_reference(tension, rate, fb, nl, init),
                           reps=1, warmup=0)
        nbytes = 4 * (2 * B * T + 4 * B)
        bound_ms, bound_by = bound(nbytes, LAW_FLOP_PER_FRAME * B * T)
        chain_ms = T * LAW_CHAIN_CYCLES / (sm_clock_mhz * 1e3)
        rows[label] = dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        emit("speed_law", case=label, B=B, T=T, rate=rate, ms=ms, device_ms=device_ms,
             device_ns_per_frame=None if device_ms is None else device_ms * 1e6 / T,
             plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
             chain_latency_bound_ms=chain_ms, sm_clock_max_mhz=sm_clock_mhz)
    emit("speed_law_bitwise",
         cases=2 + len(LAW_CASES) + 2 + len(LAW_EDGE_B) * len(LAW_EDGE_T) + 1, exact=True,
         seconds=time.perf_counter() - t0)
    return rows["60 s single call"]


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
    from speedy_tpu_torch import SpeedupEngine, SpeedyConfig, pipeline, trace
    from speedy_tpu_torch.io import wave
    from speedy_tpu_torch.ops import _build, analysis_fft, kernels, synth_model, wsola_fast
    from speedy_tpu_torch.parallel import batch

    # ---- 1. device ----
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    batch.no_tf32()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 still on")
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         sm_clock_max_mhz=sm_clock_mhz,
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
    cfg16, cfg22, cfg44 = SpeedyConfig(16000), SpeedyConfig(22050), SpeedyConfig(44100)
    rng = np.random.default_rng(0)
    inputs = front_end_inputs(dev, rng)
    (_, xs16, gain16), (_, xs22, gain22) = inputs["16kHz"], inputs["22.05kHz"]
    B, L = xs16.shape
    x60 = bench_families(60 * 16000, 16000)[0]
    front = front_end_phase(kernels, batch, inputs, x60)
    check_analysis_model(kernels, batch, analysis_fft, inputs)
    results = {}
    for name, rows in front.items():
        results[name] = dict(rows["16kHz"], shapes=rows)
    # Kernel 1 at the other sample rates it has an FFT body for, and at 7
    # and 12 kHz, whose W (105, 180) run the direct sum (B=2, 2 s; an lsd
    # frame may be off by a mask-edge flip), then the body it ran at each
    # rate: the plan its wrapper picks from W.
    for sr in (8000, 11025, 24000, 32000, 48000, 7000, 12000):
        cfg = SpeedyConfig(sr)
        x = short_input(sr, dev)
        check_analysis(kernels, batch, x, gain16[:2].contiguous(), cfg,
                       f"{sr / 1000:g}kHz B=2 L={2 * sr}", edge_frames=True)
    for label, (cfg, x, gain) in front_end_inputs(dev, rng, LONG_RUN_SHAPES).items():
        check_analysis(kernels, batch, x, gain, cfg, f"{label} L={x.shape[1]}",
                       edge_frames=True)
    # The FFT body's square root of a bin's power against sqrtf at every
    # float it takes that path for (kernels.analysis_sqrt_check, which must
    # find none).
    mismatches = kernels.analysis_sqrt_check(dev)
    check(mismatches == 0, "kernel 1's square root differs from sqrtf at", mismatches, "floats")
    emit("analysis_sqrt", mismatches=mismatches)
    results["analysis_energy_lsd"]["bodies"] = {
        rate: analysis_fft.fft_plan(cfg.window_size).route
        for rate, (cfg, _, _) in inputs.items()}
    results["analysis_energy_lsd"]["library_transform"] = (
        "torch.fft.rfft of the frames at n = 2W, and abs: the transform alone, not the "
        "kernel's function")
    tab16 = batch.device_tables(cfg16, dev)
    synth_rows = synth_phase(kernels, synth_model, inputs, x60, dev)
    results["gather_synth"] = dict(synth_rows["hop=160 B=128 K=383"], shapes=synth_rows)
    _, xs44, gain44 = inputs["44.1kHz"]
    # Kernel 4 at the single-utterance path's own shape (its arguments
    # recorded from one nonlinear_speedup call on 60 s) and at 44.1 kHz.
    path_args = recorded_call(kernels, "gather_rows", lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev))
    results["gather_rows"], _ = check_gather(
        kernels, "gather_rows", "path: 16kHz B=1 60s 3.5x", *path_args)
    # Jittered in-range starts at the batch size, kernels 5 and 8 held to
    # kernel 4's rows on them.
    ceiling16 = batch._plan_max_speed(3.5, 1.0)
    case16 = gather_case(xs16, cfg16, 3.5, 5)
    width16 = case16[2]
    w_span16 = wsola_fast.span_width(wsola_fast.SPAN_ROWS, (width16 - 1) // 2, ceiling16,
                                     cfg16.wsola_max_period, width16)
    label = "16kHz B=128 L=160000 3.5x"
    _, rows4 = check_gather(kernels, "gather_rows", label, *case16)
    for name in ("gather_rows_block", "gather_rows_block_v2"):
        check_gather(kernels, name, label, *case16, same_as=rows4,
                     rows_per_block=wsola_fast.SPAN_ROWS, w_span=w_span16)
    del case16, rows4
    check_gather(kernels, "gather_rows", "44.1kHz B=16 L=441000 3.5x",
                 *gather_case(xs44[:16].contiguous(), cfg44, 3.5, 6))

    # ---- 3b. the gather family (kernels 4-8) at the engine's shape ----
    gathers = gather_phase(kernels, wsola_fast, xs16, cfg16, ceiling16)
    check_gather_edges(kernels, dev)
    for name in ("gather_rows_block_v2", "gather_rows_pipelined", "gather_rows_coalesced"):
        results[name] = gathers[name]

    # ---- 3c. the experiment probes (kernels 9-15) ----
    results.update(probe_phase(dev))
    check_bisect_edges(kernels, dev)
    check_span_rows_unaligned(kernels, dev)
    emit("other_card", **check_other_card(kernels))

    # ---- 4. the main path ----
    rate, cap_factor = 3.5, 1.33
    engine = SpeedupEngine(cfg16, rate, 1.0, 0.1, capacity_factor=cap_factor).to(dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    launches, res = path_launches(lambda: engine(xs16, lengths, gain16))
    check(only(launches, BATCH_KERNELS), "main path skipped a kernel or left its route",
          launches)
    bodies = dict(trace.BODIES)
    check(bodies == {"analysis_energy_lsd:fft": 1}, "16 kHz kernel 1 left its FFT body",
          bodies)
    computed, owned = trace.FRAMES["analysis_energy_lsd:fft"]
    emit("main_path_frames", computed=computed, owned=owned,
         recompute_share=1 - owned / computed, plans=dict(trace.PLANS))
    # Every later step replays the engine's graphs: the checks below hold
    # a replayed step.
    res, graphs = graphed_step(engine, (xs16, lengths, gain16), (launches, bodies, res),
                               "main path")
    capacity = res.output.shape[1]
    check(capacity == batch.grid_output_capacity(cfg16, L, rate, cap_factor), "capacity")
    max_valid = int(res.valid_length.max())
    check(max_valid < capacity, "truncated output", max_valid, capacity)
    check(bool(torch.isfinite(res.output).all()), "non-finite output")
    check(bool(torch.isfinite(res.tension).all()), "non-finite tension")
    checksum = float(res.output.double().sum())
    cmp = compare_paths(batch, kernels, xs16, lengths, gain16, cfg16, rate, cap_factor,
                        res, "main")
    emit("main_path", B=B, L=L, sample_rate=16000, rate=rate, capacity=capacity,
         max_valid=max_valid, launches=launches, bodies=bodies, graphs=graphs,
         checksum=checksum, **cmp)

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
        run = lambda: batch.batched_nonlinear_speedup(x_t, l_t, cfg, r, 1.0, 0.1)
        swept, out = path_launches(run)
        # At or below 1x the batch path runs the sequential law (kernel
        # speed_law); its arguments are recorded for the speed-law phase.
        slow = r <= 1.0
        check(only(swept, SLOW_BATCH_KERNELS if slow else BATCH_KERNELS), label,
              "skipped a kernel or left its route", swept)
        if slow:
            sweep_law_args = recorded_call(kernels, "speed_law", run)
        check(bool((out.valid_length > 0).all()), label, "empty output")
        check(bool(torch.isfinite(out.output).all()), label, "non-finite output")
        cmp = compare_paths(batch, kernels, x_t, l_t, None, cfg, r, None, out, label)
        emit("sweep", case=label, launches=swept,
             checksum=float(out.output.double().sum()), **cmp)

    # ---- 5b. the batch path at 44.1 kHz (B=32 x 10 s, 3.5x, cap 1.33) ----
    B44, L44 = xs44.shape
    engine44 = SpeedupEngine(cfg44, rate, 1.0, 0.1, capacity_factor=cap_factor).to(dev)
    lengths44 = torch.full((B44,), L44, dtype=torch.int32, device=dev)
    l44, res44 = path_launches(lambda: engine44(xs44, lengths44, gain44))
    check(only(l44, BATCH_KERNELS), "44.1 kHz batch skipped a kernel or left its route", l44)
    bodies44 = dict(trace.BODIES)
    check(bodies44 == {"analysis_energy_lsd:direct": 1}, "44.1 kHz kernel 1 left its direct body",
          bodies44)
    res44, graphs44 = graphed_step(engine44, (xs44, lengths44, gain44), (l44, bodies44, res44),
                                   "44.1 kHz batch")
    cap44 = res44.output.shape[1]
    check(cap44 == batch.grid_output_capacity(cfg44, L44, rate, cap_factor), "44.1 kHz capacity")
    check(int(res44.valid_length.max()) < cap44, "44.1 kHz truncated output")
    check(bool(torch.isfinite(res44.output).all()) and bool(torch.isfinite(res44.tension).all()),
          "44.1 kHz non-finite output or tension")
    # With each path's own pitch grid the share of samples off by more than
    # 1e-3 is reported, not gated: at 44.1 kHz the phase snap multiplies
    # the two grids' period differences into chunk moves, with the old
    # kernel 2 as with the new (PERF.md, Findings; ROADMAP, C2).
    # compare_paths holds every sample to the moves of its chunks, and
    # check_pitch the two grids on these inputs: flips only at float64
    # ties, sub-sample agreement elsewhere.
    cmp = compare_paths(batch, kernels, xs44, lengths44, gain44, cfg44, rate, cap_factor,
                        res44, "44.1kHz batch", own_share_gate=False)
    emit("batch", case=f"44.1kHz B={B44} L={L44} {rate}x cap {cap_factor}", launches=l44,
         bodies=bodies44, graphs=graphs44,
         capacity=cap44, max_valid=int(res44.valid_length.max()),
         checksum=float(res44.output.double().sum()), **cmp)
    del engine44, res44

    # ---- 6. the single-utterance grid pipeline ----
    l_nl, res_nl = path_launches(lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev))
    check(only(l_nl, SINGLE_KERNELS), "single nonlinear skipped a kernel or left its route",
          l_nl)
    check(np.all(np.isfinite(res_nl.output)) and res_nl.tension.shape[0] > 0,
          "single nonlinear output")
    l_pl, plain_nl = path_launches(lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev, reference=True))
    check(not any(l_pl.values()), "the plain path launched a kernel", l_pl)
    cmp = compare_single(kernels, wsola_fast, x60, cfg16, res_nl, plain_nl,
                         "single nonlinear", dev)
    # ---- 6a. the speed law's kernel against its plain loop ----
    single_law_args = recorded_call(kernels, "speed_law", lambda: pipeline.nonlinear_speedup(
        x60, cfg16, 3.5, 1.0, 0.1, engine="grid", device=dev))
    results["speed_law"] = speed_law_phase(kernels, single_law_args, sweep_law_args, dev,
                                           sm_clock_mhz)
    emit("single", case="nonlinear 16kHz 60s 3.5x", launches=l_nl,
         achieved_rate=res_nl.achieved_rate, tension_frames=len(res_nl.tension),
         checksum=float(res_nl.output.astype(np.float64).sum()), **cmp)

    x44 = bench_families(30 * 44100, 44100)[0]
    l_li, res_li = path_launches(lambda: pipeline.linear_time_scale(
        x44, cfg44, 2.0, engine="grid", device=dev))
    check(only(l_li, SINGLE_ENGINE_KERNELS), "single linear route", l_li)
    plain_li = pipeline.linear_time_scale(x44, cfg44, 2.0, engine="grid", device=dev,
                                          reference=True)
    cmp = compare_single(kernels, wsola_fast, x44, cfg44, res_li, plain_li,
                         "single linear", dev)
    # 1.0x pass-through: the int16 input back within 1 LSB
    # (tests/test_wsola.py:122-127).
    x44i = np.clip(np.round(x44 * 32768.0), -32768, 32767).astype(np.int16)
    same = pipeline.linear_time_scale(x44i, cfg44, 1.0, engine="grid", device=dev).output
    check(same.shape == x44i.shape, "pass-through length", same.shape)
    lsb = int(np.abs(same.astype(np.int32) - x44i.astype(np.int32)).max())
    check(lsb <= 1, "pass-through off by", lsb)
    emit("single", case="linear 44.1kHz 30s 2.0x", launches=l_li,
         achieved_rate=res_li.achieved_rate, passthrough_1x_max_lsb=lsb, **cmp)

    # A speed ceiling routes synthesis to kernel 3; without one, kernel 4.
    speeds = torch.as_tensor(res_nl.speeds, device=dev)
    check(float(speeds.max()) < 6.6, "speeds above the ceiling", float(speeds.max()))
    msb = max(0.01, float(speeds.min()) * 0.999)
    l_b, r_b = path_launches(lambda: wsola_fast.time_scale_grid(
        x60, speeds, cfg16, min_speed_bound=msb, max_speed_bound=6.6, device=dev))
    l_u, r_u = path_launches(lambda: wsola_fast.time_scale_grid(
        x60, speeds, cfg16, min_speed_bound=msb, device=dev))
    check(only(l_b, ("pitch_ssd", "gather_synth")), "bounded route", l_b)
    check(only(l_u, SINGLE_ENGINE_KERNELS), "unbounded route", l_u)
    check(int(r_b.valid_length) == int(r_u.valid_length), "bounded valid_length")
    d_b = float((r_b.output - r_u.output).abs().max())
    check(d_b < 1e-6, "bounded against unbounded", d_b)
    emit("single", case="bounded 16kHz 60s, the 3.5x run's speeds, ceiling 6.6",
         launches_bounded=l_b, launches_unbounded=l_u, valid_length=int(r_b.valid_length),
         max_abs_err=d_b)

    # ---- 6b. the span synthesis route (kernel 5) against kernel 3 ----
    # On the bounded 60 s run's chunk positions, then at shape A from the
    # batch step's speeds (capacity for the slowest speed 1.0, K = 1,009).
    n60 = len(x60)
    l_span, y_span, v_span = span_route_check(
        kernels, wsola_fast, tab16, torch.as_tensor(x60, device=dev)[None],
        torch.tensor([n60], dtype=torch.int32, device=dev), speeds[None], None, cfg16,
        wsola_fast.plan_grid(cfg16, n60, msb)[1], 6.6,
        "16kHz 60s, the 3.5x run's speeds, ceiling 6.6")
    check(int(v_span[0]) == int(r_b.valid_length), "span route valid_length")
    d_span = float((y_span[0] - r_b.output).abs().max())
    check(d_span < 1e-6, "span route against time_scale_grid's kernel 3", d_span)
    span_route_check(
        kernels, wsola_fast, tab16, xs16, lengths, res.speeds, gain16, cfg16,
        wsola_fast.plan_grid(cfg16, L, 1.0)[1], ceiling16,
        f"shape A: 16kHz B={B} 10s, the batch step's speeds, ceiling {ceiling16}")

    # ---- 7. the CLI ----
    emit("cli", **run_cli_phase(pipeline, wave, cfg16,
                                bench_families(20 * 16000, 16000)[0], dev))

    # Launches: the batched path's run for its kernels, the single
    # nonlinear run for kernel 4 and the speed law, the 60 s span route run
    # for kernel 5, the gather phase's runs at shape A for kernels 6-8, and
    # each probe's answer passes for kernels 9-15 (the batch step and the
    # single call launch none of them). Times, errors and bounds: kernels
    # 1-3 at the batch shape, kernel 4 and the speed law at the single
    # path's shape, kernels 5-8 at shape A, the probes at probe_headline's
    # rows.
    launches["gather_rows"] = l_nl["gather_rows"]
    launches["speed_law"] = l_nl["speed_law"]
    launches["gather_rows_block"] = l_span["gather_rows_block"]
    results["gather_rows_block"] = gathers["gather_rows_block"]
    for name in ("gather_rows_block_v2", "gather_rows_pipelined", "gather_rows_coalesced",
                 *PROBE_KERNELS):
        launches[name] = results[name]["launches"]
    # Kernels 1 and 2 add their device ms at each shape, and kernel 1 the
    # body it ran at each rate (their direct-sum floors are on the phase's
    # kernel lines). Their bounds are the benchmark's, which say nothing of
    # what bounds them; every other kernel's bound says "bound_by".
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    extra = {
        "analysis_energy_lsd": ("library_transform_ms", "library_transform", "bodies",
                                "shapes"),
        "pitch_ssd": ("shapes",),
        "gather_synth": ("bound_by", "bound_share", "shapes"),
        "narrow_operand_sum": ("bound_by", "floor_device_ms", "over_floor"),
        "bisect_span_rows": ("bound_by", "floor_device_ms", "over_floor"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         **{k: results[name][k] for k in keys + extra.get(name, ("bound_by",))}}
        for name, (src, tpu) in KERNEL_SOURCES.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def device_profile(fn):
    """Device time of one call of fn under torch.profiler: the summed
    kernel time in ms; None when the profiler saw no device work (not
    measured). The program's "speedy:" ranges, which the profiler also
    puts on the device's timeline, are not device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speedy_tpu_torch import trace

    fn()
    torch.cuda.synchronize()
    # A profiler run now and then records no device work for a short
    # call; up to three runs are tried.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(trace.PREFIX)]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3
    return None


if __name__ == "__main__":
    sys.exit(main())
