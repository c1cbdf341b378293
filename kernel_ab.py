#!/usr/bin/env python3
"""Kernels of two checkouts of the port, timed in turns on one card.

    python3 kernel_ab.py OTHER        (from the repository root; one card)

OTHER is another checkout of the repository, e.g. a `git archive` of a
parent commit unpacked into a directory that .gitignore lists. Four
processes run in turn, OTHER, this, this, OTHER, each building its own
checkout's kernels and timing them with this checkout's clocks
(chip_smoke.py, speedy_tpu_torch/experiments/timing.py):
  - kernels 1 and 2 (the analysis front-end and the pitch search) through
    chip_smoke.front_end_phase: each against its plain version, with its
    gates, at 16 kHz B=128, 22.05 kHz B=8 and 44.1 kHz B=32 (10 s
    utterances of the benchmark's four families), and kernel 2 also on
    the 60 s single call's input; kernel 1 also at 7, 12, 47.3 and 96 kHz
    B=2 x 2 s (chip_smoke.short_input), whose W run the direct sum (47.3
    and 96 kHz in several rounds of pairs), and a sha256 of its energy
    and lsd bytes at 44.1 kHz B=32 and at each of those (analysis_digests);
  - where the checkout's plan chooses how a pair of bins reads the
    direct sum's twiddles, kernel 1's direct body at 44.1 kHz B=32 and
    47.3 kHz B=2 in both forms, one twiddle load for both bins (the
    plan's, code 1) and one for each (code 0), bitwise to each other
    (direct_forms);
  - the launch path: kernel 13 (lane_roll, [64, 512] by 266) and kernel
    15 (transpose_cols, [512, 128], each form) timed as pairs with their
    library calls, kernel 3 at the batch step's shape (hop 160, B=128,
    K=383), at hops 220 (B=8), 441 (B=4), 80, 110 and 480 (B=8) and on
    one 60 s row (synth_cases), kernel 4 at the single call's shape (B=1,
    60 s) and the speed law on the 60 s call's tension and on seeded
    [128, 999] tension at 3.5x, fb 0.1 and fb 0.0; for each, CUDA-event
    ms, the host's cost of one launch (launch_us: 200 calls back to back)
    and device ms (torch.profiler), and the parts of one launch in
    microseconds (launch_parts); a sha256 of the speed law's speeds and
    durations at its three shapes (law_digests);
  - kernel 11 (synth_bisect) at every stage of its probe's cases (the
    6.0x span, then full at 4.0x) on the probe's inputs: CUDA-event and
    device ms, and a sha256 of each output (synth_bisect_digests);
  - where the checkout has ops/synth_model.py (kernel 3 in runs of S
    slots a block), kernel 3's device ms at S = 1 .. 16 beside the plan's
    S, at the same shapes (synth_runs);
  - each checkout's share of output samples more than 1e-3 off the plain
    path, each path with its own tension and pitch grid, at 16 kHz and
    44.1 kHz (3.5x, capacity factor 1.33).
Each process prints its rows as one JSON line; the last line is the
summary: per kernel and shape, each checkout's median over its two
processes of every time (this checkout's alone for synth_runs and
direct_forms), and kernel 2's integer flips and share of cells
more than 0.1 sample off the float64 search; per digest shape (kernel
1's, kernel 11's and the speed law's), whether all four processes gave
the same bytes (bitwise_to_other). The card's name and power limit come
first.

    python3 kernel_ab.py --measure ROOT

is one such process: the checkout at ROOT, one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "integer_flips",
        "kernel_share_off_f64_0p1", "library_transform_ms", "launch_us", "library_ms",
        "library_launch_us")
TIMES = ("ms", "device_ms", "launch_us", "library_ms", "library_launch_us")
# The rows that hold a sha256 per shape, compared across the four processes.
DIGESTS = ("analysis_digests", "synth_bisect_digests", "law_digests")


def median_of(values):
    """The median of the values that were measured; None if none was."""
    got = [v for v in values if v is not None]
    return statistics.median(got) if got else None


def this_timing():
    """This checkout's experiments/timing.py, loaded by its path: the
    same clocks for both checkouts' kernels."""
    path = HERE / "speedy_tpu_torch" / "experiments" / "timing.py"
    spec = importlib.util.spec_from_file_location("kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_rows(chip_smoke, kernels, pipeline, inputs, synth, x60, dev) -> dict:
    """Kernels 13 and 15 (each form) paired with their library calls,
    kernel 3 at each of synth's shapes (synth_cases), kernel 4 and the
    speed law at the single call's: {kernel: {shape: {ms, launch_us,
    device_ms, ...}}}. Each call's output is checked against its library
    call or plain version first."""
    import numpy as np
    import torch

    clock = this_timing()

    def row(call, library=None):
        r = {}
        if library is None:
            r["ms"] = clock.time_ms(call, dev)
        else:
            r["ms"], r["library_ms"] = clock.paired_ms(call, library, dev)
            r["library_launch_us"] = clock.launch_us(library, dev)
        r["launch_us"] = clock.launch_us(call, dev)
        r["device_ms"] = clock.device_ms(call, dev)
        return r

    rng = np.random.default_rng(0)
    xr = torch.as_tensor(rng.standard_normal((64, 512)).astype(np.float32), device=dev)
    roll = lambda: kernels.lane_roll(xr, 266)
    chip_smoke.check(torch.equal(roll(), torch.roll(xr, 266, 1)), "lane_roll")
    rows = {"lane_roll": {"64x512 by 266": row(roll, lambda: torch.roll(xr, 266, 1))}}

    rng = np.random.default_rng(0)
    xt = torch.as_tensor(rng.standard_normal((512, 128)).astype(np.float32), device=dev)
    eye = torch.eye(512, dtype=torch.float32, device=dev)
    cols = lambda: xt[:, :8].t().contiguous()
    rows["transpose_cols"] = {}
    for form in ("swap", "dot_rhsT", "dot_lhsT"):
        call = lambda: kernels.transpose_cols(xt, eye, form)
        chip_smoke.check(torch.equal(call(), cols()), "transpose_cols", form)
        rows["transpose_cols"][f"512x128 {form}"] = row(call, cols)

    rows["gather_synth"] = {}
    for label, args in synth.items():
        err = float((kernels.gather_synth(*args)
                     - kernels.gather_synth_reference(*args)).abs().max())
        chip_smoke.check(err <= 1e-5, "gather_synth", label, err)
        rows["gather_synth"][label] = row(lambda: kernels.gather_synth(*args))

    cfg16 = inputs["16kHz"][0]
    single = lambda: pipeline.nonlinear_speedup(x60, cfg16, 3.5, 1.0, 0.1, engine="grid",
                                                device=dev)
    rec = chip_smoke.recorded_call(kernels, "gather_rows", single)
    chip_smoke.check(torch.equal(kernels.gather_rows(*rec), kernels.gather_rows_reference(*rec)),
                     "gather_rows differs from its plain version")
    rows["gather_rows"] = {"path: 16kHz B=1 60s 3.5x": row(lambda: kernels.gather_rows(*rec))}
    rows["speed_law"] = {}
    for shape, args in law_cases(chip_smoke, kernels, single, dev).items():
        got, want = kernels.speed_law(*args), kernels.speed_law_reference(*args)
        chip_smoke.check(all(torch.equal(g, w) for g, w in zip((got[0], *got[1]),
                                                               (want[0], *want[1]))),
                         "speed_law", shape, "differs from its plain loop")
        rows["speed_law"][shape] = row(lambda: kernels.speed_law(*args))
    return rows


def law_cases(chip_smoke, kernels, single, dev) -> dict:
    """The speed law's arguments: the 60 s single call's (recorded), and
    chip_smoke.py's seeded [128, 999] tension at 3.5x, fb 0.1 and fb 0.0
    (nonlinear factor 1): shape label -> args."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    seeded = torch.as_tensor((rng.standard_normal((128, 999)) * 0.5).astype(np.float32),
                             device=dev)
    return {"the 60s call's tension": chip_smoke.recorded_call(kernels, "speed_law", single),
            "[128, 999] 3.5x fb 0.1": (seeded, 3.5, 0.1, 1.0, None),
            "[128, 999] 3.5x fb 0.0": (seeded, 3.5, 0.0, 1.0, None)}


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, one after another."""
    import hashlib

    import torch

    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def law_digests(chip_smoke, kernels, pipeline, inputs, x60, dev) -> dict:
    """sha256 of the speed law's speeds and final durations at each of
    law_cases: shape label -> hex digest."""
    single = lambda: pipeline.nonlinear_speedup(x60, inputs["16kHz"][0], 3.5, 1.0, 0.1,
                                                engine="grid", device=dev)
    out = {}
    for shape, args in law_cases(chip_smoke, kernels, single, dev).items():
        speeds, (cur, des) = kernels.speed_law(*args)
        out[shape] = digest(speeds, cur, des)
    return out


def synth_bisect_rows(kernels, dev) -> tuple:
    """Kernel 11 at every stage of the probe's cases (the 6.0x span, then
    full at 4.0x) on the probe's inputs: ({case: {ms, launch_us,
    device_ms}}, {case: sha256 of the output}), timed by this checkout's
    clocks."""
    import numpy as np
    import torch
    from speedy_tpu_torch.experiments import synth_bisect as probe

    clock = this_timing()
    p = probe.plan()
    rng = np.random.default_rng(0)
    af = torch.as_tensor(rng.uniform(0, 1, (probe.BATCH, p["K"])).astype(np.float32),
                         device=dev)
    x = probe.signal(rng, p, dev)
    starts, n_valid = probe.starts_n_valid(p, dev)
    rows, digests = {}, {}
    for stage, speed in probe.CASES:
        kw = dict(hop=p["hop"], rows_per_block=probe.R, w_span=probe.span_plan(p, speed))
        call = lambda: kernels.synth_bisect(x, starts, af, n_valid, stage, **kw)
        label = f"{stage} {speed}x"
        digests[label] = digest(call())
        rows[label] = {"ms": clock.time_ms(call, dev), "device_ms": clock.device_ms(call, dev)}
    return rows, digests


SYNTH_RUNS = (1, 2, 3, 4, 6, 8, 12, 16)
# Kernel 1's direct-sum rates beside the front-end shapes: label -> rate.
SHORT_RATES = {"7kHz B=2": 7000, "12kHz B=2": 12000, "47.3kHz B=2": 47300,
               "96kHz B=2": 96000}


def short_cases(chip_smoke, inputs, dev) -> dict:
    """Kernel 1's inputs at SHORT_RATES as chip_smoke.py gives them:
    label -> (cfg, x [2, 2 s], gain)."""
    from speedy_tpu_torch.config import SpeedyConfig

    gain = inputs["16kHz"][2][:2].contiguous()
    return {label: (SpeedyConfig(sr), chip_smoke.short_input(sr, dev), gain)
            for label, sr in SHORT_RATES.items()}


def analysis_digests(chip_smoke, kernels, batch, cases) -> dict:
    """sha256 of kernel 1's energy then lsd bytes on the arguments
    batch.batched_analysis passes it, for each (cfg, x, gain) of cases:
    label -> hex digest."""
    import hashlib

    import torch

    out = {}
    for label, (cfg, x, gain) in cases.items():
        T = cfg.num_frames(x.shape[1], integer_step=True)
        args = chip_smoke.recorded_call(kernels, "analysis_energy_lsd",
                                        lambda: batch.batched_analysis(x, cfg, T, gain))
        e, l = kernels.analysis_energy_lsd(*args)
        torch.cuda.synchronize()
        h = hashlib.sha256(e.cpu().numpy().tobytes())
        h.update(l.cpu().numpy().tobytes())
        out[label] = h.hexdigest()
    return out


def direct_forms(chip_smoke, kernels, batch, _build, cases, dev) -> dict:
    """Kernel 1's direct body on each of cases whose plan finds the table
    mirrored, launched through its C entry point in both pairing forms:
    code 1, one twiddle load a sample for bins k and W-k (the plan's), and
    code 0, each bin its own; each output held bitwise to the wrapper's.
    The device ms of each (the median of three profiler readings, the
    forms in turns): label -> {"mirrored_ms", "own_entries_ms"}. Empty for
    a checkout whose plan has no such choice."""
    import numpy as np
    import torch
    from speedy_tpu_torch.ops import analysis_fft

    if not hasattr(analysis_fft, "kernel_code"):
        return {}
    clock = this_timing()
    fn = _build.load()["analysis_energy_lsd"]
    rows = {}
    for label, (cfg, x, gain) in cases.items():
        T = cfg.num_frames(x.shape[1], integer_step=True)
        args = chip_smoke.recorded_call(kernels, "analysis_energy_lsd",
                                        lambda: batch.batched_analysis(x, cfg, T, gain))
        xs, g, ham, _, _, table, T, step = args
        (B, L), W = xs.shape, ham.shape[0]
        plan = analysis_fft.fft_plan(W)
        if plan.route != "direct" or not plan.mirrored:
            continue
        want = kernels.analysis_energy_lsd(*args)
        e, l = torch.empty_like(want[0]), torch.empty_like(want[1])
        ptrs = [t.data_ptr() for t in (xs, g, ham, table, e, l)]
        eps = float(np.float32(kernels.C.EPS))
        forms = {"mirrored_ms": 1, "own_entries_ms": 0}
        calls = {}
        for key, code in forms.items():
            calls[key] = (lambda c: lambda: fn(*ptrs, B, L, T, W, step, c, eps,
                                               torch._C._cuda_getCurrentRawStream(dev.index)))(code)
            e.fill_(float("nan"))
            l.fill_(float("nan"))
            chip_smoke.check(calls[key]() == 0, "analysis_energy_lsd", label, key)
            chip_smoke.check(torch.equal(e, want[0]) and torch.equal(l, want[1]),
                             "analysis_energy_lsd", label, key, "differs from the wrapper's")
        times = {key: [] for key in forms}
        for turn in range(3):
            for key in (forms if turn % 2 == 0 else list(forms)[::-1]):
                times[key].append(clock.device_ms(calls[key], dev))
        rows[label] = {key: median_of(v) for key, v in times.items()}
    return rows


def synth_cases(chip_smoke, wsola_fast, inputs, dev) -> dict:
    """Kernel 3's arguments at chip_smoke.py's shapes (hop 160 B=128, hop
    220 B=8, hop 441 B=4, one 60 s row at 16 kHz) and at hops 80, 110 and
    480 (B=8, 10 s of the families at 8, 11.025 and 48 kHz), chunk
    positions from chip_smoke.synth_case: label -> args."""
    import torch

    (_, xs16, g16), (_, xs22, g22), (_, xs44, _) = (
        inputs["16kHz"], inputs["22.05kHz"], inputs["44.1kHz"])
    x60 = chip_smoke.bench_families(60 * 16000, 16000)[:1]
    shapes = {"hop=160 B=128 K=383": (xs16, g16, 160, 383, 3.5),
              "hop=220 B=8 K=400": (xs22, g22, 220, 400, 3.0),
              "hop=441 B=4 K=400": (xs44[:4].contiguous(), g22[:4].contiguous(), 441, 400, 3.0),
              "hop=160 B=1 60s K=1715": (torch.as_tensor(x60, device=dev),
                                         g16[:1].contiguous(), 160, 1715, 3.5)}
    for sr in (8000, 11025, 48000):
        x = chip_smoke.batch_of(chip_smoke.bench_families(10 * sr, sr), 8)
        shapes[f"hop={sr // 100} B=8 K=400"] = (torch.as_tensor(x, device=dev), g22,
                                                sr // 100, 400, 3.0)
    out = {}
    for label, (x, gain, hop, K, rate) in shapes.items():
        B, L = x.shape
        a_i, a_f, valid, capacity = chip_smoke.synth_case(B, L, hop, K, rate, 11, dev)
        win = torch.as_tensor(wsola_fast._cola_hann(2 * hop), device=dev)
        out[label] = (x, a_i, a_f, win, gain, valid, hop, capacity)
    return out


def synth_runs(chip_smoke, kernels, _build, synth, dev) -> dict:
    """Kernel 3's device ms at each run length S of SYNTH_RUNS (the median
    of three profiler readings), launched through its C entry point with S
    given, each output held bitwise to the plain version: label ->
    {"plan": the plan's S, "S<n>": ms}. Empty for a checkout without
    ops/synth_model.py."""
    import torch

    try:
        from speedy_tpu_torch.ops import synth_model
    except ImportError:
        return {}
    clock = this_timing()
    fn = _build.load()["gather_synth"]
    rows = {}
    for label, args in synth.items():
        x, a_i, a_f, win, gain, valid, hop, capacity = args
        (B, L), K = x.shape, a_i.shape[1]
        want = kernels.gather_synth_reference(*args)
        out = torch.empty_like(want)
        ptrs = [t.data_ptr() for t in (x, a_i, a_f, win, gain, valid, out)]
        row = {"plan": synth_model.synth_plan(B, hop, capacity).run}
        for run in SYNTH_RUNS:
            call = lambda: fn(*ptrs, B, L, K, hop, capacity, run,
                              torch._C._cuda_getCurrentRawStream(dev.index))
            out.fill_(float("nan"))
            chip_smoke.check(call() == 0, "gather_synth", label, "S", run)
            chip_smoke.check(torch.equal(out, want), "gather_synth", label, "S", run, "differs")
            # The median of three profiler readings: now and then the
            # profiler records only part of the device work.
            row[f"S{run}"] = median_of([clock.device_ms(call, dev) for _ in range(3)])
        rows[label] = row
    return rows


def launch_parts(kernels, _build, dev) -> dict:
    """Microseconds of each part of a launch, each the median of 5 runs of
    2,000 calls: the two ways to read the current stream, the two ways to
    read the current device, a device context entered and left, an output
    allocated (two ways), kernel 13's ctypes call alone (device already
    current; also through a handle that keeps the GIL, and with R = 0, which
    returns before the launch: ctypes' own cost), its whole wrapper, and
    torch.roll."""
    import ctypes
    import time

    import torch

    x = torch.zeros(64, 512, device=dev)
    out = torch.empty_like(x)
    lib = _build.load()
    fn = lib["lane_roll"] if isinstance(lib, dict) else lib.speedy_lane_roll
    held = getattr(ctypes.PyDLL(str(_build.build())), "speedy_lane_roll")
    held.argtypes, held.restype = fn.argtypes, fn.restype
    raw = torch._C._cuda_getCurrentRawStream

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "current_stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: raw(0),
        "current_device": torch.cuda.current_device,
        "raw_device": torch._C._cuda_getDevice,
        "device_context": context,
        "empty_like": lambda: torch.empty_like(x),
        "empty": lambda: torch.empty((64, 512), dtype=torch.float32, device=dev),
        "ctypes_call": lambda: fn(x.data_ptr(), out.data_ptr(), 64, 512, 266, raw(0)),
        "ctypes_call_gil_held": lambda: held(x.data_ptr(), out.data_ptr(), 64, 512, 266,
                                             raw(0)),
        "ctypes_no_launch": lambda: fn(x.data_ptr(), out.data_ptr(), 0, 512, 266, raw(0)),
        "wrapper": lambda: kernels.lane_roll(x, 266),
        "torch_roll": lambda: torch.roll(x, 266, 1),
    }
    result = {}
    for name, part in parts.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(2000):
                part()
            runs.append((time.perf_counter() - t0) / 2000 * 1e6)
        result[name] = statistics.median(runs)
    torch.cuda.synchronize(dev)
    return result


def measure(root: str) -> dict:
    """front_end_phase with the kernels of the checkout at root."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import speedy_tpu_torch
    from speedy_tpu_torch import pipeline
    from speedy_tpu_torch.ops import _build, kernels, wsola_fast
    from speedy_tpu_torch.parallel import batch

    dev = torch.device("cuda", 0)
    batch.no_tf32()
    rng = np.random.default_rng(0)
    inputs = chip_smoke.front_end_inputs(dev, rng)
    x60 = chip_smoke.bench_families(60 * 16000, 16000)[0]
    rows = chip_smoke.front_end_phase(kernels, batch, inputs, x60)
    short = short_cases(chip_smoke, inputs, dev)
    for label, (cfg, x, gain) in short.items():
        rows["analysis_energy_lsd"][label] = chip_smoke.check_analysis(
            kernels, batch, x, gain, cfg, f"{label} L={x.shape[1]}", edge_frames=True)
    synth = synth_cases(chip_smoke, wsola_fast, inputs, dev)
    rows.update(launch_rows(chip_smoke, kernels, pipeline, inputs, synth, x60, dev))
    out = {name: {shape: {k: r[k] for k in KEYS if k in r} for shape, r in by_shape.items()}
           for name, by_shape in rows.items()}
    out["launch_parts_us"] = launch_parts(kernels, _build, dev)
    out["synth_bisect"], out["synth_bisect_digests"] = synth_bisect_rows(kernels, dev)
    out["law_digests"] = law_digests(chip_smoke, kernels, pipeline, inputs, x60, dev)
    out["analysis_digests"] = analysis_digests(
        chip_smoke, kernels, batch, {"44.1kHz B=32": inputs["44.1kHz"], **short})
    out["synth_runs"] = synth_runs(chip_smoke, kernels, _build, synth, dev)
    out["direct_forms"] = direct_forms(
        chip_smoke, kernels, batch, _build,
        {"44.1kHz B=32": inputs["44.1kHz"], "47.3kHz B=2": short["47.3kHz B=2"]}, dev)
    # The batch path against the plain path, each with its own tension and
    # pitch grid: the share of valid output samples off by more than 1e-3.
    out["own_grid_share"] = {}
    for label in ("16kHz", "44.1kHz"):
        cfg, xs, gain = inputs[label]
        B, L = xs.shape
        lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
        engine = speedy_tpu_torch.SpeedupEngine(cfg, 3.5, 1.0, 0.1, capacity_factor=1.33)
        res = engine.to(dev)(xs, lengths, gain)
        plain = batch.batched_nonlinear_speedup(xs, lengths, cfg, 3.5, 1.0, 0.1, gain=gain,
                                                capacity_factor=1.33, reference=True)
        off = ((res.output - plain.output).abs() > 1e-3).sum()
        out["own_grid_share"][label] = float(off) / max(int(res.valid_length.sum()), 1)
    return {"root": str(pathlib.Path(speedy_tpu_torch.__file__).parent.parent), "rows": out}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(pathlib.Path(sys.argv[1]).resolve())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        root = other if who == "other" else str(HERE)
        proc = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--measure", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[who].append(json.loads(line)["rows"])
    summary = {"own_grid_share": {who: rs[0]["own_grid_share"] for who, rs in runs.items()},
               "launch_parts_us": {
                   who: {k: statistics.median(r["launch_parts_us"][k] for r in rs)
                         for k in rs[0]["launch_parts_us"]}
                   for who, rs in runs.items()}}
    for part in DIGESTS:
        summary[part] = {
            label: {"this": runs["this"][0][part][label],
                    "bitwise_to_other": len({r[part].get(label) for rs in runs.values()
                                             for r in rs}) == 1}
            for label in runs["this"][0][part]}
    for part in ("synth_runs", "direct_forms"):
        summary[part] = {
            label: {k: median_of([r[part][label][k] for r in runs["this"]]) for k in row}
            for label, row in runs["this"][0][part].items()}
    for name, by_shape in runs["this"][0].items():
        if name in ("own_grid_share", "launch_parts_us", "synth_runs", "direct_forms",
                    *DIGESTS):
            continue
        for shape in by_shape:
            row = {}
            for who, rs in runs.items():
                for k in TIMES:
                    vals = [r[name][shape][k] for r in rs if r[name][shape].get(k) is not None]
                    if vals:
                        row[f"{who}_{k}"] = statistics.median(vals)
                for k in ("integer_flips", "kernel_share_off_f64_0p1"):
                    if k in rs[0][name][shape]:
                        row[f"{who}_{k}"] = rs[0][name][shape][k]
            summary[f"{name} {shape}"] = row
    print(json.dumps({"summary": summary, "other": other}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
