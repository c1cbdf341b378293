"""The traced run: the harness's spans around the program's layers, and the
reduction of torch.profiler's trace to the record that the per-layer
readers (portbench/metrics/*.py) read.

Spans are torch.profiler.record_function ranges that the harness puts
around the program's functions by replacing module attributes for the
traced calls only (no file of the program changes). Every device event
(kernel, copy, set) is given to the innermost harness span that was open
on the host when it was launched, by the correlation id that joins a
launch to its device event.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "pb:"
WINDOW, CALL = PREFIX + "window", PREFIX + "call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def spans(targets: Iterable[Tuple[object, str, str]]):
    """Wrap module.attr in a record_function range named pb:<span> for each
    (module, attr, span) while the block runs, and restore it after."""
    import torch

    saved = []
    try:
        for module, attr, span in targets:
            orig = getattr(module, attr)

            def wrapped(*a, __orig=orig, __name=PREFIX + span, **kw):
                with torch.profiler.record_function(__name):
                    return __orig(*a, **kw)

            functools.update_wrapper(wrapped, orig)
            saved.append((module, attr, orig))
            setattr(module, attr, wrapped)
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _innermost(ranges: List[Tuple[float, float, str]], starts: List[float], t: float):
    """The shortest harness range that holds time t, or None."""
    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        a, b, name = ranges[i]
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def _host_timeline(ranges, starts, w0: float, w1: float):
    """[w0, w1] cut into pieces, each with what the host was doing: the
    innermost harness span, "between_layers" inside a call but no layer,
    "between_calls" outside every call."""
    cuts = sorted({w0, w1, *(t for a, b, _ in ranges for t in (a, b) if w0 < t < w1)})
    pieces = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        span = _innermost(ranges, starts, 0.5 * (a + b))
        name = ("between_calls" if span is None else
                "between_layers" if span == CALL[len(PREFIX):] else span)
        pieces.append((a, b, name))
    return pieces


def reduce(events: List[dict]) -> Dict[str, object]:
    """A chrome trace's events -> the traced window's device record:
    busy_s and window_s, device seconds by operation name and by harness
    span, the kernel count, copy seconds by direction, and the idle gaps'
    seconds by what the host was doing over each stretch of them (the
    innermost span, "between_layers" inside a call, "between_calls" outside
    one)."""
    ranges = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"][len(PREFIX):])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and str(e.get("name", "")).startswith(PREFIX)
    )
    window = [r for r in ranges if r[2] == WINDOW[len(PREFIX):]]
    if not window:
        raise ValueError("the trace holds no pb:window range")
    w0, w1 = window[0][0], window[0][1]
    layer_ranges = [r for r in ranges if r[2] != WINDOW[len(PREFIX):]]
    starts = [r[0] for r in layer_ranges]
    launch_at = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at.setdefault(e["args"]["correlation"], e["ts"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and w0 <= e["ts"] <= w1]
    by_op: Dict[str, float] = {}
    by_span: Dict[str, float] = {}
    copies: Dict[str, float] = {}
    unattributed = 0
    for e in device:
        s = e.get("dur", 0.0) * 1e-6
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + s
        if e["cat"] == "gpu_memcpy":
            kind = "HtoD" if "HtoD" in e["name"] else "DtoH" if "DtoH" in e["name"] else "other"
            copies[kind] = copies.get(kind, 0.0) + s
        at = launch_at.get(e.get("args", {}).get("correlation"))
        span = None if at is None else _innermost(layer_ranges, starts, at)
        if at is None:
            unattributed += 1
        key = span if span not in (None, CALL[len(PREFIX):]) else "other"
        by_span[key] = by_span.get(key, 0.0) + s
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)) for e in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = {}
    pieces = _host_timeline(layer_ranges, starts, w0, w1)
    piece_starts = [p[0] for p in pieces]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        k = max(0, bisect.bisect_right(piece_starts, a) - 1)
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                gaps[pieces[k][2]] = gaps.get(pieces[k][2], 0.0) + (hi - lo) * 1e-6
            k += 1
    return {
        "window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
        "device_ops": by_op, "span_device_s": by_span, "copies_s": copies,
        "kernel_count": sum(1 for e in device if e["cat"] == "kernel"),
        "unattributed_events": unattributed, "idle_gaps": gaps,
    }


def profile_calls(call, first: int, n: int, targets) -> Dict[str, object]:
    """Run call(first), ..., call(first + n - 1) under torch.profiler inside
    a pb:window range, each call in a pb:call range and the program's
    layers in their spans; returns reduce() of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with spans(targets):
        with profile(activities=acts):  # the profiler's own start-up, untimed
            call(first)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(first + 1, first + 1 + n):
                    with torch.profiler.record_function(CALL):
                        call(i)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    record = reduce(events)
    record["calls"] = n
    return record


def breakdown(record: Dict[str, object], top: int = 10) -> Optional[dict]:
    """The ten device operations that took most time and the ten largest
    idle gaps by host activity, as [name, seconds] pairs."""
    ops = sorted(record["device_ops"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(record["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:96], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
