"""The port's counterparts of the repository's experiments/ probes that
reach a Pallas kernel, under the same file names:

  bf16_split_probe        kernel 9   kernels.bf16_split_matmul
  gather_bisect           kernel 10  kernels.gather_bisect
  synth_bisect            kernel 11  kernels.synth_bisect
  lane1_blockspec_probe   kernel 12  kernels.narrow_operand_sum
  multitile_roll_probe    kernel 13  kernels.lane_roll
  bisect_kernel           kernel 14  kernels.bisect_span_rows
  mosaic_transpose_probe  kernel 15  kernels.transpose_cols

Each puts its experiment's question to the card and prints the answer, one
JSON line a case (bisect_kernel also takes the experiment's `which R
w_rows`):

    python -m speedy_tpu_torch.experiments.<probe> [--device cuda]

Each module has one function, check(device). It first asks the
probe's question once through its kernel, each row recording the
launches that took (its answer pass); then it holds the kernel to its
plain version, and to the library call where there is one; then, on the
card, it takes the times that chip_smoke.py reports (timing.py): the
median CUDA-event time of a call (ms; for a kernel far under a launch,
the launch path's) and the device time of its kernel alone (device_ms,
by torch.profiler). Kernels 13 and 15, whose bodies run at the card's
floor for a launch, time kernel and library call as pairs in one loop
(paired_ms) and add each one's host cost of a launch (launch_us,
library_launch_us); kernels 12 and 14 add the card's floor for one launch
in the same process (floor_device_ms, a one-element fill_) and their
device ms over it (over_floor). It returns one row a case with the
answer, the errors and the times. A failed check raises ProbeFailure. On the CPU the
wrappers run their plain versions, and no time is taken.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

from .. import trace
from .timing import device_ms, floor_device_ms, launch_us, paired_ms, time_ms  # noqa: F401


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


def add_increments(rows: list) -> list:
    """rows with increment_ms and increment_device_ms: each row's ms and
    device_ms less the row before's (None for the first row or where a
    time is None), what each stage adds to the one before."""
    for key in ("ms", "device_ms"):
        rows[0][f"increment_{key}"] = None
        for prev, row in zip(rows, rows[1:]):
            a, b = prev[key], row[key]
            row[f"increment_{key}"] = None if a is None or b is None else b - a
    return rows


def covered(first: torch.Tensor, length, total: int) -> int:
    """How many of the words [0, total) the intervals [first, first +
    length) cover together: what a function that reads them must read,
    each word once. length is an int or a tensor shaped like first."""
    first = first.reshape(-1).long()
    end = (first + length).reshape(-1) if torch.is_tensor(length) else first + length
    one = torch.ones_like(first)
    d = torch.zeros(total + 1, dtype=torch.long, device=first.device)
    d.index_add_(0, first.clamp(0, total), one)
    d.index_add_(0, end.clamp(0, total), -one)
    return int((d.cumsum(0)[:total] > 0).sum())


def launched(name: str, fn: Callable):
    """fn()'s result and how many times it launched kernel `name`
    (trace.LAUNCHES)."""
    before = trace.LAUNCHES[name]
    out = fn()
    return out, trace.LAUNCHES[name] - before


def run_main(doc: str, check: Callable, argv=None) -> int:
    """A probe's command line, --device (default cuda); prints check()'s
    rows as JSON lines."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for row in check(ap.parse_args(argv).device):
        print(json.dumps(row), flush=True)
    return 0
