#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Builds the port's CUDA kernels from speedy_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version on the card, drives the main
path (SpeedupEngine: B=128 utterances of 10 s at 16 kHz, 3.5x, capacity
factor 1.33, per-utterance gain) and checks it against the same call
through the plain versions, then runs the dryrun sweep cases (0.7x with a
ragged length; 22.05 kHz 3.0x). Prints one line per phase, a JSON line of
the kernels' launches, errors and times, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failed check raises, so the
exit code is non-zero and no result line is printed. Imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
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
}
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
    from speedy_tpu_torch import SpeedupEngine, SpeedyConfig
    from speedy_tpu_torch.ops import _build, kernels
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
    xs44 = torch.as_tensor(batch_of(bench_families(441000, 44100), 4), device=dev)
    check_synth(kernels, xs44, gain22[:4].contiguous(), 441, 400, 3.0, "hop=441 B=4 K=400")

    # ---- 4. the main path ----
    rate, cap_factor = 3.5, 1.33
    engine = SpeedupEngine(cfg16, rate, 1.0, 0.1, capacity_factor=cap_factor).to(dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = engine(xs16, lengths, gain16)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(all(n > 0 for n in launches.values()), "main path skipped a kernel", launches)
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
        check(all(n > 0 for n in swept.values()), label, "skipped a kernel", swept)
        check(bool((out.valid_length > 0).all()), label, "empty output")
        check(bool(torch.isfinite(out.output).all()), label, "non-finite output")
        cmp = compare_paths(batch, kernels, x_t, l_t, None, cfg, r, None, out, label)
        emit("sweep", case=label, launches=swept,
             checksum=float(out.output.double().sum()), **cmp)

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
