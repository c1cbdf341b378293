#!/usr/bin/env python3
"""Kernels 1 and 2 (the analysis front-end and the pitch search) of two
checkouts of the port, timed in turns on one card.

    python3 kernel_ab.py OTHER        (from the repository root; one card)

OTHER is another checkout of the repository, e.g. a `git archive` of a
parent commit unpacked into a directory that .gitignore lists. Four
processes run in turn, OTHER, this, this, OTHER, each building its own
checkout's kernels and running chip_smoke.front_end_phase with them: each
kernel against its plain version, with its gates, at 16 kHz B=128,
22.05 kHz B=8 and 44.1 kHz B=32 (10 s utterances of the benchmark's four
families), and kernel 2 also on the 60 s single call's input. Each
process prints its rows as one JSON line; the last line is the summary:
per kernel and shape, each checkout's CUDA-event ms and device ms
(torch.profiler), the median over its two processes, and kernel 2's
integer flips and share of cells more than 0.1 sample off the float64
search, and each checkout's share of output samples more than 1e-3 off
the plain path, each path with its own tension and pitch grid, at 16 kHz
and 44.1 kHz (3.5x, capacity factor 1.33). The card's name and power
limit come first.

    python3 kernel_ab.py --measure ROOT

is one such process: the checkout at ROOT, one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "integer_flips",
        "kernel_share_off_f64_0p1", "library_transform_ms")


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
    from speedy_tpu_torch.ops import kernels
    from speedy_tpu_torch.parallel import batch

    dev = torch.device("cuda", 0)
    batch.no_tf32()
    rng = np.random.default_rng(0)
    inputs = chip_smoke.front_end_inputs(dev, rng)
    x60 = chip_smoke.bench_families(60 * 16000, 16000)[0]
    rows = chip_smoke.front_end_phase(kernels, batch, inputs, x60)
    out = {name: {shape: {k: r[k] for k in KEYS if k in r} for shape, r in by_shape.items()}
           for name, by_shape in rows.items()}
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
    summary = {"own_grid_share": {who: rs[0]["own_grid_share"] for who, rs in runs.items()}}
    for name, by_shape in runs["this"][0].items():
        if name == "own_grid_share":
            continue
        for shape in by_shape:
            row = {}
            for who, rs in runs.items():
                for k in ("ms", "device_ms"):
                    vals = [r[name][shape][k] for r in rs if r[name][shape].get(k) is not None]
                    row[f"{who}_{k}"] = statistics.median(vals) if vals else None
                for k in ("integer_flips", "kernel_share_off_f64_0p1"):
                    if k in rs[0][name][shape]:
                        row[f"{who}_{k}"] = rs[0][name][shape][k]
            summary[f"{name} {shape}"] = row
    print(json.dumps({"summary": summary, "other": other}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
