"""The port's counterparts of the repository's experiments/ probes that
reach a Pallas kernel, under the same file names:

  bf16_split_probe        kernel 9   kernels.bf16_split_matmul
  lane1_blockspec_probe   kernel 12  kernels.narrow_operand_sum
  multitile_roll_probe    kernel 13  kernels.lane_roll
  mosaic_transpose_probe  kernel 15  kernels.transpose_cols

Each puts its experiment's question to the card and prints the answer, one
JSON line a case:

    python -m speedy_tpu_torch.experiments.<probe> [--device cuda]

Each module has one function, check(device). It first asks the
probe's question once through its kernel, each row recording the
launches that took (its answer pass); then it holds the kernel to its
plain version, and to the library call where there is one; then, on the
card, it takes the times that chip_smoke.py reports: the median
CUDA-event time of a call (ms; for a kernel far under a launch, the
launch path's) and the device time of its kernel alone (device_ms, by
torch.profiler). It returns one row a case with the answer, the errors
and the times. A failed check raises ProbeFailure. On the CPU the
wrappers run their plain versions, and no time is taken.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Optional

import torch


class ProbeFailure(AssertionError):
    pass


def require(ok, *what) -> None:
    if not ok:
        raise ProbeFailure(" ".join(str(w) for w in what))


def probe_device(device) -> torch.device:
    """The device a probe was asked for (kernels.resolve_device), with TF32
    off on the card (dft.no_tf32): the plain versions' and library calls'
    float32 products must be exact float32."""
    from ..ops import dft, kernels

    dev = kernels.resolve_device(device)
    if dev.type == "cuda":
        dft.no_tf32()
    return dev


def time_ms(fn: Callable, device: torch.device, reps: int = 20,
            warmup: int = 3) -> Optional[float]:
    """Median device time of fn() in ms, by CUDA events around each call;
    None off the card (not measured)."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
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


def launched(name: str, fn: Callable):
    """fn()'s result and how many times it launched kernel `name`
    (kernels.LAUNCHES)."""
    from ..ops import kernels

    before = kernels.LAUNCHES[name]
    out = fn()
    return out, kernels.LAUNCHES[name] - before


def run_main(doc: str, check: Callable, argv=None) -> int:
    """A probe's command line, --device (default cuda); prints check()'s
    rows as JSON lines."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for row in check(ap.parse_args(argv).device):
        print(json.dumps(row), flush=True)
    return 0
