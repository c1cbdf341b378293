"""The frozen roofline arithmetic: the least time one NVIDIA H100 could
take for a kernel's work, from the work its inputs need (each input byte
read once, each output byte written once, operations counted as
chip_smoke.py:370 and :446 count them).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit; the run
prints the card's power limit beside every share.
"""

from __future__ import annotations

import math
import re

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Device kernel names in the profiler's trace (speedy_tpu_torch/csrc).
KERNEL_NAMES = {
    "analysis": re.compile(r"(^|\W)(fft_kernel|direct_kernel)\W"),
    "pitch": re.compile(r"(^|\W)pitch_kernel\W"),
}


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def rfft_flop(n: int) -> float:
    """The usual count of a real FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def analysis_bound_s(B: int, L: int, W: int, T: int) -> float:
    """Kernel 1 on B rows of L samples, T frames of W: pre-emphasis and
    window (3 FLOP a sample), bins 1..W-1 of the frame zero-padded to 2W by
    a real FFT or, if fewer, the direct sums' 2*W*(W-1) FMAs, and 13 FLOP a
    bin (magnitude, energy, threshold, normalisation, masked log ratio).
    Reads x, gain, window and twiddles once; writes energy and lsd."""
    spectrum = min(rfft_flop(2 * W), 4.0 * W * (W - 1))
    nbytes = 4 * (B * L + B + W + 4 * W + 2 * B * T)
    return bound_s(nbytes, (3 * W + spectrum + 13 * (W - 1)) * B * T)


def pitch_bound_s(B: int, L: int, taps: int, min_period: int, max_period: int,
                  n_grid: int) -> float:
    """Kernel 2 on B rows, n_grid cells each: the gain (1 FLOP a sample of
    the seg_w = 2*max_period window), the template's correlation at each of
    nl lags by FFTs of seg_w points (two forward, one inverse, 6 FLOP a bin
    between) or, if fewer, taps FMAs a lag, running-sum energies (2 FLOP a
    sample) and 4 FLOP a lag for the SSD and the argmin. Reads x and gain
    once; writes the periods."""
    seg_w = 2 * max_period
    nl = max_period - min_period + 1
    corr = min(3 * rfft_flop(seg_w) + 6 * (seg_w // 2 + 1), 2.0 * taps * nl)
    nbytes = 4 * (B * L + B + B * n_grid)
    return bound_s(nbytes, (3 * seg_w + corr + 4 * nl) * B * n_grid)


def kernel_device_s(device_ops: dict, role: str) -> float:
    """Device seconds of the trace's kernels that match KERNEL_NAMES[role]."""
    pattern = KERNEL_NAMES[role]
    return sum(s for name, s in device_ops.items() if pattern.search(name + " "))
