"""The program's own spans and sync counts (speedy_tpu_torch/trace.py) in a
cell's traced calls: a tool, not run by the benchmark. From the root of a
checkout, on a CUDA device:

    python3 portbench/program_spans.py --workload <cell> --seed <n> [--cost-rounds 4]

It makes the cell's inputs and warms up as run.py does, profiles
traffic["trace_calls"] calls with run.py's own profiling.profile_calls
(pb:window and pb:call ranges, the harness's pb: layer spans around the
program's), and prints one JSON line: the host-blocking transfers a call
by the program's count, the host ms a call inside the program's
speedy:sync:* spans and inside its outer span (batch or file) outside
them, the transfers and their bytes by site over the profiled calls
(trace.SYNCS, trace.SYNC_BYTES), the idle gaps by the innermost speedy:
span, and the kernels' load seconds with whether that load built them
(trace.LOAD_S, trace.LOAD_BUILT). With --cost-rounds, it then times calls
with no profiler, under the profiler with the program's spans, and under
it with the spans off (as a program without them), in turns.

reduce() is what the benchmark's profiling.reduce() would add to its
record to report these readings as per-layer metrics; once it does,
_profile's wrapping of profile_calls goes (PERF.md, Open questions)"""

from __future__ import annotations

import bisect
import importlib
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    _here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != _here]
    sys.path.insert(0, str(pathlib.Path(_here).parent))

from portbench import profiling  # noqa: E402

PROGRAM = "speedy:"
OUTER = ("batch", "file")  # the program's outer span, one a call
SYNC = "sync:"


def _ranges(events: List[dict], prefix: str) -> List[Tuple[float, float, str]]:
    """The host's record_function ranges named prefix + name, as (start,
    end, name), sorted."""
    return sorted(
        (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"][len(prefix):])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and str(e.get("name", "")).startswith(prefix)
    )


def _idle_gaps(ranges, busy, w0: float, w1: float) -> Dict[str, float]:
    """Seconds of [w0, w1] outside every busy interval, by the innermost of
    ranges open at the time, as profiling._host_timeline names it (ranges
    holds the pb:call ranges as "call")."""
    starts = [r[0] for r in ranges]
    pieces = profiling._host_timeline(ranges, starts, w0, w1)
    piece_starts = [p[0] for p in pieces]
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        k = max(0, bisect.bisect_right(piece_starts, a) - 1)
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                gaps[pieces[k][2]] = gaps.get(pieces[k][2], 0.0) + (hi - lo) * 1e-6
            k += 1
    return gaps


def reduce(events: List[dict]) -> Dict[str, object]:
    """A chrome trace's events -> the program's spans inside the pb:window
    range: host seconds in its outer spans by name ("outer_host_s"), in its
    sync spans by site ("sync_host_s") and their count ("sync_spans"), the
    outer spans' seconds outside their sync spans ("issue_host_s"), and the
    idle gaps by the innermost program span ("idle_gaps"; "between_layers"
    inside a pb:call range but no program span, "between_calls" outside
    every call)."""
    harness = _ranges(events, profiling.PREFIX)
    window = [r for r in harness if r[2] == profiling.WINDOW[len(profiling.PREFIX):]]
    if not window:
        raise ValueError("the trace holds no pb:window range")
    w0, w1 = window[0][0], window[0][1]
    busy = profiling._union([
        (max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)) for e in events
        if e.get("ph") == "X" and e.get("cat") in profiling.DEVICE_CATS and w0 <= e["ts"] <= w1
    ])
    ranges = [r for r in _ranges(events, PROGRAM) if w0 <= r[0] <= w1]
    calls = [r for r in harness if r[2] == profiling.CALL[len(profiling.PREFIX):]]
    outer = [r for r in ranges if r[2] in OUTER]
    outer_s: Dict[str, float] = {}
    for a, b, name in outer:
        outer_s[name] = outer_s.get(name, 0.0) + (b - a) * 1e-6
    sync_s: Dict[str, float] = {}
    sync_n: Dict[str, int] = {}
    inside = 0.0
    for a, b, name in ranges:
        if name.startswith(SYNC):
            site = name[len(SYNC):]
            sync_s[site] = sync_s.get(site, 0.0) + (b - a) * 1e-6
            sync_n[site] = sync_n.get(site, 0) + 1
            if any(oa <= a and b <= ob for oa, ob, _ in outer):
                inside += (b - a) * 1e-6
    return {
        "outer_host_s": outer_s, "sync_host_s": sync_s, "sync_spans": sync_n,
        "issue_host_s": sum(outer_s.values()) - inside,
        "idle_gaps": _idle_gaps(sorted(ranges + calls), busy, w0, w1) if ranges else {},
    }


def readings(program: Dict[str, object], syncs: Dict[str, int], calls: int,
             unit: str) -> Dict[str, float]:
    """The per-call readings under the names they would have as per-layer
    metrics: syncs a call (the program's count), host ms in sync spans and
    in the outer span outside them; empty where the program has no outer
    span (a program without its own spans)."""
    outer, tag = ("batch", "step") if unit == "step" else ("file", "call")
    suffix = "batch" if unit == "step" else "file"
    if outer not in program["outer_host_s"]:
        return {}
    return {
        f"host_syncs_per_{tag}.{suffix}": sum(syncs.values()) / calls,
        f"sync_wait_ms.{suffix}": sum(program["sync_host_s"].values()) / calls * 1e3,
        f"host_issue_ms.{suffix}": program["issue_host_s"] / calls * 1e3,
    }


def breakdown(program: Dict[str, object], top: int = 10) -> Optional[dict]:
    """The ten largest idle gaps by the innermost program span, and the sync
    sites by host seconds as [site, seconds, spans]."""
    if not program["outer_host_s"]:
        return None
    gaps = sorted(program["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    syncs = sorted(program["sync_host_s"].items(), key=lambda kv: -kv[1])
    return {"idle_gaps": [[k, v] for k, v in gaps],
            "sync_host_s": [[k, v, program["sync_spans"][k]] for k, v in syncs]}


def _profile(entry, first: int, n: int, trace) -> tuple:
    """run.py's traced calls, by the harness's own profiling.profile_calls
    with its reduce() wrapped to keep the trace: (chrome trace events, the
    trace.SYNCS and trace.SYNC_BYTES deltas over the n profiled calls, next
    call index). The deltas start after the untimed call(first)."""
    before, kept = {}, {}

    def call(i):
        out = entry.call(i)
        if i == first:
            before.update(syncs=dict(trace.SYNCS), bytes=dict(trace.SYNC_BYTES))
        return out

    reduce = profiling.reduce

    def keep(events):
        kept["events"] = events
        return reduce(events)

    profiling.reduce = keep
    try:
        profiling.profile_calls(call, first, n, entry.span_targets)
    finally:
        profiling.reduce = reduce
    deltas = [{k: v - old.get(k, 0) for k, v in now.items() if v != old.get(k, 0)}
              for now, old in ((trace.SYNCS, before["syncs"]),
                               (trace.SYNC_BYTES, before["bytes"]))]
    return kept["events"], deltas[0], deltas[1], first + 1 + n


def _cost(entry, first: int, n: int, rounds: int, trace) -> dict:
    """Host ms a call with no profiler ("off"), under the profiler with the
    program's spans ("on") and with trace.layer returning the null context
    ("on_nospans"), rounds in rotating order; medians over the rounds."""
    import gc
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    modes = ("off", "on", "on_nospans")
    layer = trace.layer
    ms = {m: [] for m in modes}
    i = first
    for r in range(rounds):
        for k in range(len(modes)):
            mode = modes[(r + k) % len(modes)]
            if mode == "on_nospans":
                trace.layer = lambda name: trace._OFF
            prof = None if mode == "off" else profile(activities=acts)
            try:
                if prof is not None:
                    prof.__enter__()
                t = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    entry.call(i)
                    t.append(time.perf_counter() - t0)
                    i += 1
                torch.cuda.synchronize()
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
                trace.layer = layer
            del prof
            gc.collect()
            ms[mode].append(statistics.mean(t) * 1e3)
    med = {m: statistics.median(v) for m, v in ms.items()}
    return {"ms_a_call": ms, "median": med, "profiler_ms": med["on_nospans"] - med["off"],
            "spans_ms": med["on"] - med["on_nospans"]}


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import run
    from speedy_tpu_torch import trace

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost-rounds", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    bench = run._read_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(run.ROOT, bench, args.workload)
    module = importlib.import_module(f"portbench.entries.{files['entry']}")
    entry = module.Entry(files["config"], files["traffic"], args.seed, torch.device("cuda:0"))
    entry.warm_up(10.0)
    n = files["traffic"]["trace_calls"]
    events, syncs, sync_bytes, nxt = _profile(entry, 0, n, trace)
    program = reduce(events)
    out = {"workload": args.workload, "seed": args.seed, "calls": n,
           "device": torch.cuda.get_device_name(0), "power_limit": run.power_limit(),
           "readings": readings(program, syncs, n, entry.unit),
           "syncs": syncs, "sync_bytes": sync_bytes,
           "kernel_load_s": trace.LOAD_S, "kernel_load_built": trace.LOAD_BUILT,
           "program_breakdown": breakdown(program)}
    if args.cost_rounds:
        out["cost"] = _cost(entry, nxt, n, args.cost_rounds, trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
