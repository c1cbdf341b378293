"""Does a 1-wide operand cost anything on the H100?

Port of experiments/lane1_blockspec_probe.py through kernel 12
(kernels.narrow_operand_sum, csrc/narrow_operands.cu). Per utterance b of
96, the kernel writes o[b, 0:8, 0] = a * amp + b + c of rows 0..7, column
0, reading only those 3 x 8 words, a thread an output. The probe's window
sums o over 24 amps, one launch each. Two layouts of the same 16 KiB
block: narrow [4096, 1], where an utterance's eight words of an operand
share one 32-byte sector, and lane-dense [32, 128], where they lie 512
bytes apart. On the TPU a 1-wide block pads to 128 lanes in VMEM when the
BlockSpec copies it; on the card a contiguous [4096, 1] tensor holds the
same consecutive words as a [32, 128] one and nothing is copied, so the
two layouts' device times answer the question.

    python -m speedy_tpu_torch.experiments.lane1_blockspec_probe [--device cuda]

Prints one JSON line a layout: the window's value from the kernel and the
plain version, and on the card the median ms of one launch, its device ms
beside the card's floor for one launch (floor_device_ms, a one-element
fill_, and over_floor, the ratio), the plain version's ms, and the
24-launch window's ms a step (the probe's own figure).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import device_ms, floor_device_ms, launched, probe_device, require, run_main, time_ms

B, N, NIT = 96, 4096, 24  # experiments/lane1_blockspec_probe.py:16-17
SHAPES = ((N, 1), (N // 128, 128))


def inputs(device) -> dict:
    """Per layout, a, b, c [96, R, C] and 24 amps in [0.5, 1), drawn as the
    probe's run() draws them, narrow layout first, from one seed-0
    generator (lane1_blockspec_probe.py:18, 47-51)."""
    rng = np.random.default_rng(0)
    out = {}
    for shape in SHAPES:
        a, b, c = (torch.as_tensor(rng.standard_normal((B,) + shape).astype(np.float32),
                                   device=device) for _ in range(3))
        amps = rng.uniform(0.5, 1.0, (NIT,)).astype(np.float32)
        out[shape] = (a, b, c, [float(v) for v in amps])
    return out


def outputs(a, b, c, amps, fn=None) -> list:
    """fn(a, b, c, amp) for each amp, one launch each; fn is
    kernels.narrow_operand_sum unless given."""
    fn = fn or kernels.narrow_operand_sum
    return [fn(a, b, c, amp) for amp in amps]


def window(outs) -> torch.Tensor:
    """The probe's window (lane1_blockspec_probe.py:27-42): the sum of the
    launches' outputs, in turn, in float32."""
    total = torch.zeros((), dtype=torch.float32, device=outs[0].device)
    for o in outs:
        total = total + o.sum()
    return total


def check(device="cuda") -> list:
    """The probe's window at both layouts through kernel 12, and the
    kernel against its plain version: every launch's outputs bitwise (the
    same three float32 roundings in the same order), and the two windows
    within 1e-6 of the window's size. One row a layout, with the window's
    ms a step and the kernel's device ms over the card's floor for one
    launch, taken in this process."""
    device = probe_device(device)
    ref = kernels.narrow_operand_sum_reference
    floor = floor_device_ms(device)
    rows = []
    for shape, (a, b, c, amps) in inputs(device).items():
        outs, n = launched("narrow_operand_sum", lambda: outputs(a, b, c, amps))
        plains = outputs(a, b, c, amps, ref)
        d = max(float((o - p).abs().max()) for o, p in zip(outs, plains))
        require(all(torch.equal(o, p) for o, p in zip(outs, plains)), shape,
                "kernel against plain", d)
        w_k, w_p = float(window(outs)), float(window(plains))
        require(abs(w_k - w_p) <= 1e-6 * max(abs(w_p), 1.0), shape, "window", w_k, w_p)
        call = lambda: kernels.narrow_operand_sum(a, b, c, amps[0])

        def per_step(fn):
            ms = time_ms(lambda: window(outputs(a, b, c, amps, fn)), device)
            return None if ms is None else ms / NIT

        dev_ms = device_ms(call, device)
        rows.append(dict(
            probe="lane1_blockspec", shape=[B, *shape], amps=len(amps), launches=n,
            window=w_k, plain_window=w_p, max_abs_err=d,
            ms=time_ms(call, device), device_ms=dev_ms, floor_device_ms=floor,
            over_floor=None if dev_ms is None or not floor else dev_ms / floor,
            plain_ms=time_ms(lambda: ref(a, b, c, amps[0]), device), library_ms=None,
            window_ms_per_step=per_step(None), plain_window_ms_per_step=per_step(ref)))
    return rows


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
