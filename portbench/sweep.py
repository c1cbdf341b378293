"""The batch step over batch sizes, to find the knee where the card stops
idling: for each B, audio_s_per_s over a short window and the device's idle
share from a few profiled steps (the benchmark's own window and reduction).
One JSON line a B. Benchmark runs never run this; the choice of a later
batch-size cell reads it.

    python3 portbench/sweep.py --workload corpus16k.b128 --batches 128,512,4096 --seconds 5
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def sweep_one(workload: str, batch: int, seconds: float, seed: int, device: str) -> dict:
    import torch

    from portbench import profiling, run, stats
    from portbench.entries.batch import Entry

    files = run.cell_files(ROOT, run._read_json(ROOT / "BENCHMARK.json"), workload)
    traffic = dict(files["traffic"], batch=batch, kept_calls=1)
    entry = Entry(files["config"], traffic, seed, torch.device(device))
    entry.warm_up(seconds)
    times, i, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        entry.call(i)
        times.append(time.perf_counter() - a)
        i += 1
    window = time.perf_counter() - t0
    prof = profiling.profile_calls(entry.call, i, traffic["trace_calls"], entry.span_targets)
    out = {"batch": batch, "steps": i, "audio_s_per_s": i * entry.work_per_call / window,
           "step_ms_p95": stats.p95(times) * 1e3,
           "idle_share": 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]),
           "busy_ms_per_step": prof["busy_s"] / prof["calls"] * 1e3,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    del entry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="corpus16k.b128")
    p.add_argument("--batches", default="128,512,1024,2048,4096,8192")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parent)
    if here in sys.path:
        sys.path.remove(here)
    sys.path.insert(0, str(ROOT))
    for b in args.batches.split(","):
        print(json.dumps(sweep_one(args.workload, int(b), args.seconds, args.seed, "cuda:0")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
