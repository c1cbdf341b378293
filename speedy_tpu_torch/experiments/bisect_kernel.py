"""Which part of a copy of kernel 5's body fails or costs time on the H100?

Port of experiments/bisect_kernel.py through kernel 14
(kernels.bisect_span_rows, csrc/gather_bisect.cu): B = 2 utterances of
1,600 rows of 128 samples, NB = 3 blocks of R * 4 slab rows each (the
second utterance's last block dead), a span of w_rows rows from a seeded
base, and seeded row picks q8k (seed 0, in the experiment's order). The
experiment's `which` picks how far the body runs: none (any name but the
three below: q8k in every lane, no copy), dma (the span's first R * 4 rows
+ q8k), dot (span row q8k, the one-hot select) and full (dot barrel-shifted
with q8k as each row's bits, which is no single shift).

    python -m speedy_tpu_torch.experiments.bisect_kernel [which R w_rows] [--device cuda]

With `which R w_rows` (as the experiment takes them) it prints one JSON
line for that mode; without them, one a mode at R = 128, w_rows = 1,024.
A line holds the experiment's checksum, the sum of each block's first row,
taken over the live blocks (the port writes the dead block as zeros; the
TPU kernel leaves it unwritten), the launches, the difference from the
plain version, and on the card the median ms of a call by CUDA events and
the device ms of the kernel (torch.profiler), each with its increment over
the mode before, the card's floor for one launch (floor_device_ms, a
one-element fill_ in the same process) and the device ms over it
(over_floor), and the plain version's ms.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import kernels
from . import (add_increments, covered, device_ms, floor_device_ms, launched, probe_device,
               require, time_ms)

B, NB, NT, LENGTH_ROWS = 2, 3, 4, 1600  # experiments/bisect_kernel.py:8-11
NVB = (3, 2)
MODES = ("none", "dma", "dot", "full")  # no copy, then the body's stages in order
CHECK_R, CHECK_W_ROWS = 128, 1024


def inputs(R: int, w_rows: int, device) -> tuple:
    """nvb [2], bases [2, 3], q8k [2, 3, R * 4] and x2 [3,200 + w_rows + 16,
    128], drawn as bisect_kernel.py:52-56 draws them."""
    rng = np.random.default_rng(0)
    bases = (rng.integers(0, 20, (B, NB)) * 8).astype(np.int32)
    q8k = rng.integers(0, w_rows - 1, (B, NB, R * NT, 1)).astype(np.int32)
    x2 = rng.standard_normal((B * LENGTH_ROWS + w_rows + 16, 128)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (
        np.array(NVB, np.int32), bases, q8k.reshape(B, NB, R * NT), x2))


def read_words(mode: str, nvb, bases, q8k, x2, R: int) -> int:
    """The words a mode's function must read, each once: q8k, and for the
    copies nvb, bases and the x2 rows the live blocks' slabs come from (dma,
    the first R * 4 span rows; dot and full, the rows q8k picks)."""
    if mode not in kernels.SPAN_ROWS_STAGES:
        return q8k.numel()
    tot = R * NT
    first = torch.arange(B, device=x2.device)[:, None] * LENGTH_ROWS + bases  # [B, NB]
    live = torch.arange(NB, device=x2.device)[None, :] < nvb[:, None]
    if mode == "dma":
        rows = covered(first[live], tot, x2.shape[0])
    else:
        rows = covered((first[..., None] + q8k)[live], 1, x2.shape[0])
    return q8k.numel() + B + B * NB + rows * kernels.LANES


def run(mode: str, R: int, w_rows: int, device, floor=None) -> dict:
    """One mode through kernel 14 (the answer pass), held bitwise to its
    plain version; then on the card the times, the device ms also over
    floor, the card's floor for one launch (floor_device_ms; taken here
    when not given). One row."""
    device = probe_device(device)
    if floor is None:
        floor = floor_device_ms(device)
    nvb, bases, q8k, x2 = inputs(R, w_rows, device)
    kw = dict(rows_per_block=R, w_rows=w_rows, nt=NT, length_rows=LENGTH_ROWS)
    call = lambda: kernels.bisect_span_rows(nvb, bases, q8k, x2, mode, **kw)
    plain = lambda: kernels.bisect_span_rows_reference(nvb, bases, q8k, x2, mode, **kw)
    out, n = launched("bisect_span_rows", call)
    ref = plain()
    d = float((out - ref).abs().max())
    require(torch.equal(out, ref), mode, R, w_rows, "kernel 14 against its plain version", d)
    dev_ms = device_ms(call, device)
    return dict(
        probe="bisect_kernel", mode=mode, R=R, w_rows=w_rows, launches=n,
        checksum_live_blocks=float(out[:, :, :1].sum()), max_abs_err=d,
        out_words=out.numel(), read_words=read_words(mode, nvb, bases, q8k, x2, R),
        ms=time_ms(call, device), device_ms=dev_ms, floor_device_ms=floor,
        over_floor=None if dev_ms is None or not floor else dev_ms / floor,
        plain_ms=time_ms(plain, device), library_ms=None)


def check(device="cuda") -> list:
    """Every mode at R = 128, w_rows = 1,024 (R * 4 = 512 rows a block), in
    MODES' order, with each one's increments over the mode before, all
    read against one floor for a launch."""
    floor = floor_device_ms(probe_device(device))
    return add_increments([run(mode, CHECK_R, CHECK_W_ROWS, device, floor) for mode in MODES])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", help="dma, dot, full, or any other name (no copy)")
    ap.add_argument("R", nargs="?", type=int, default=CHECK_R)
    ap.add_argument("w_rows", nargs="?", type=int, default=CHECK_W_ROWS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = (check(args.device) if args.which is None
            else [run(args.which, args.R, args.w_rows, args.device)])
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
