"""Clocks for the probes, and for kernel_ab.py's rows: CUDA events around
a call, a kernel and its library call in pairs, the host's cost of one
launch, and the device time alone by torch.profiler. Each returns None
off the card (not measured).

Imports torch alone and nothing of the package, so kernel_ab.py can load
this file by its path and time another checkout's kernels with the same
clocks.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch


def _event_ms(fn: Callable) -> float:
    """CUDA-event ms of one fn() on an idle stream: its device work and the
    host's launch path between the two events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn: Callable, device: torch.device, reps: int = 20,
            warmup: int = 3) -> Optional[float]:
    """Median device time of fn() in ms, by CUDA events around each call;
    None off the card (not measured)."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    return statistics.median(_event_ms(fn) for _ in range(reps))


def paired_ms(fn: Callable, other: Callable, device: torch.device, reps: int = 40,
              warmup: int = 3):
    """(median ms of fn(), median ms of other()) by CUDA events, the two
    alternating call by call in one loop, so that a drift of the host's
    speed within the process falls on both alike; (None, None) off the
    card. Only such pairs decide which of two launch-bound calls is
    faster: the same call's time spreads 2x between processes."""
    if device.type != "cuda":
        return None, None
    for _ in range(warmup):
        fn()
        other()
    torch.cuda.synchronize(device)
    a, b = [], []
    for _ in range(reps):
        a.append(_event_ms(fn))
        b.append(_event_ms(other))
    return statistics.median(a), statistics.median(b)


def launch_us(fn: Callable, device: torch.device, calls: int = 200,
              repeats: int = 5) -> Optional[float]:
    """The host's cost of one fn() in microseconds: the host-clock time of
    `calls` back-to-back calls after a synchronise, with none between
    them, divided by `calls`; the median of `repeats` such runs. For a call
    whose device work is shorter than its launch this is the time that
    bounds a stream of them. None off the card."""
    if device.type != "cuda":
        return None
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize(device)
    return statistics.median(runs)


def device_ms(fn: Callable, device: torch.device, reps: int = 20) -> Optional[float]:
    """Device time of one fn() call in ms: the durations of the device
    kernels (and copies) torch.profiler records over reps calls, after one
    warm-up call, summed and divided by reps. Unlike time_ms it leaves out
    the host's launch path. None off the card, or when the profiler records
    no device work (not measured)."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
