"""Readings for the limits of portbench/limits/<cell>.json: every number the
comparison can hold (judge.Tally.numbers), from the program on many seeds
(the lower readings) and from the control on a few (the upper readings),
read in one process at the cell's own size:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

The program's answers come from its timed path, a short window of the
cell's own calls. The control is the plain reference computed with every
product in TF32 (reference.plain.Plain(tf32=True)) put in the program's
place. One JSON line a seed on standard output. Benchmark runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, seconds: float, control: bool, device,
             overrides: dict = None) -> dict:
    import importlib

    import torch

    from portbench import judge, run

    files = run.cell_files(ROOT, run._read_json(ROOT / "BENCHMARK.json"), workload)
    entry = importlib.import_module(f"portbench.entries.{files['entry']}").Entry(
        files["config"], dict(files["traffic"], **(overrides or {})), seed, torch.device(device))
    entry.warm_up(seconds)
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        entry.call(i)
        i += 1
    calls, window = i, time.perf_counter() - t0
    entry.finish(i)
    entry.release()
    tally = judge.Tally()
    t1 = time.perf_counter()
    n = entry.compare(tally, tf32_control=control)
    return {"workload": workload, "seed": seed, "side": "control" if control else "program",
            "answers": n, "compare_s": time.perf_counter() - t1, "calls": calls,
            "ms_per_call": window / calls * 1e3, **tally.numbers()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parent)
    if here in sys.path:
        sys.path.remove(here)
    sys.path.insert(0, str(ROOT))
    for side, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(readings(args.workload, int(s), args.seconds, side, args.device)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
