"""Does a rotate across a multi-tile row stay exact on the H100, and what
does it cost?

Port of experiments/multitile_roll_probe.py through kernel 13
(kernels.lane_roll, csrc/lane_roll.cu): np.roll(x, 266, axis=1) of x
[64, 512] (seed 0 standard normals). On the TPU a 512-lane row spans four
vector tiles, and kernel 2's forward-DFT split needed its segment tail at
that lane offset; the probe asked whether Mosaic lowers the rotate.

    python -m speedy_tpu_torch.experiments.multitile_roll_probe [--device cuda]

Prints one JSON line: whether the kernel equals np.roll bit for bit, and
on the card the kernel's and the library call torch.roll's median ms,
timed as pairs, each one's host cost of a launch (us), the kernel's and
the library's device ms, and the plain version's ms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import (device_ms, launch_us, launched, paired_ms, probe_device, require, run_main,
               time_ms)

GC, G, SHIFT = 64, 512, 512 - 246  # experiments/multitile_roll_probe.py:18


def inputs(device) -> torch.Tensor:
    """x [64, 512] (multitile_roll_probe.py:33)."""
    x = np.random.default_rng(0).standard_normal((GC, G)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def check(device="cuda") -> list:
    """Whether kernel 13 equals np.roll bit for bit; it must, and equal
    its plain version and torch.roll bit for bit. One row."""
    device = probe_device(device)
    x = inputs(device)
    out, n = launched("lane_roll", lambda: kernels.lane_roll(x, SHIFT))
    exact = bool(np.array_equal(out.cpu().numpy(), np.roll(x.cpu().numpy(), SHIFT, axis=1)))
    plain = kernels.lane_roll_reference(x, SHIFT)
    require(exact, "lane roll differs from np.roll")
    require(torch.equal(out, plain), "lane roll differs from the plain version")
    require(torch.equal(out, torch.roll(x, SHIFT, 1)), "lane roll differs from torch.roll")
    call = lambda: kernels.lane_roll(x, SHIFT)
    library = lambda: torch.roll(x, SHIFT, 1)
    ms, library_ms = paired_ms(call, library, device)
    return [dict(
        probe="multitile_roll", R=GC, G=G, shift=SHIFT, launches=n, exact=exact,
        max_abs_err=float((out - plain).abs().max()),
        ms=ms, library_ms=library_ms, launch_us=launch_us(call, device),
        library_launch_us=launch_us(library, device), device_ms=device_ms(call, device),
        library_device_ms=device_ms(library, device),
        plain_ms=time_ms(lambda: kernels.lane_roll_reference(x, SHIFT), device))]


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
