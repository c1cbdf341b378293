"""Kernel 1's transform: the plan and tables of the spectrum that
csrc/analysis.cu computes in shared memory, and a float32 model of its
stages.

A frame's spectrum is bins 0..W-1 of its W samples zero-padded to
N = 2W points, X[k] = sum_{n<W} x[n] exp(-2 pi i n k / N). The plan is
picked from W alone, before any launch, and names one of the kernel's two
bodies:

  stockham   W is one of FFT_WINDOWS, the frames of the sample rates users
             run whose prime factors are all at most 11 (8, 11.025, 16,
             22.05, 24, 32, 48 kHz); the kernel has each one's plan
             compiled in: a float32 FFT. Each frame has its own
             transform, so a silent frame's spectrum is exactly zero
             whatever its neighbours hold (two frames packed into one
             complex transform leak each other's rounding into both). The
             N real points are one complex sequence of W,
             z[m] = x[2m] + i x[2m+1], nonzero for m < ceil(W/2); a
             mixed-radix Stockham FFT gives Z = DFT_W(z), and for k in
             [1, W)
                 E = (Z[k] + conj Z[W-k]) / 2,  O = (Z[k] - conj Z[W-k]) / 2i,
                 X[k] = E + exp(-i pi k / W) O.
             For an even W the first stage is a radix 2 over a sequence
             whose upper half is zero, so it only duplicates each sample.
  direct     every other W, among them those with a larger prime factor
             (44.1 kHz: W = 661, a prime): the direct sum, 2W(W-1)
             multiply-adds a frame, bins k and W-k by one thread. Where
             the float32 table mirrors the pair exactly (mirrored: every
             prime W), bin W-k's twiddle at sample n is bin k's with the
             signs (-1)^n and -(-1)^n, so one table read serves both; else
             each bin reads its own. A chirp-z
             transform (power-of-two FFTs of 1,024 points at 44.1 kHz) held
             float32's accuracy against float64 but not chip_smoke.py's
             tension gate against the plain version, whose matmul rounds
             as the direct sum does: a 40 dB mask-edge flip's tail through
             the low-pass passed 2e-5 on a frame whose own bins sit far
             from the threshold (PERF.md, Findings).

Every table is built in float64 from W and rounded once to float32, as
[rows, 2] (re, im): for stockham the twiddles exp(-2 pi i m / W), m < W
(every stage's twiddle and every butterfly's root is one of them), then
the post-pass turns exp(-i pi k / W), k < W; for direct the 2W twiddles
exp(-2 pi i m / 2W), bins 0..W of the DFT basis' n = 1 row and their
mirror, as dft.dft_matrices rounds them. packed_table() lays them out as
the kernel reads them; SpeedupEngine keeps it as a buffer.

spectrum_model() runs the kernel's stages in the kernel's order in float32
with PyTorch. It is a test oracle for the plan and the tables
(tests/test_torch_analysis_fft.py) and, on the card, for the kernel
(chip_smoke.py holds kernel 1 to it); no path of the port calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import dft

# The butterflies csrc/analysis.cu has, and the radix order of a plan:
# eights, fours and twos first (the fewest stages), then the rest.
RADICES = (8, 4, 2, 3, 5, 11)
# The W that csrc/analysis.cu has an FFT body for (fft_kernel_for): the
# frames of 8, 11.025, 16, 22.05, 24, 32 and 48 kHz.
FFT_WINDOWS = (120, 165, 240, 330, 360, 480, 720)


class FftPlan(NamedTuple):
    W: int             # frame length: N = 2W real points
    route: str         # "stockham" or "direct"
    radices: tuple     # stockham: the W-point FFT's stage radices; direct: ()
    zero_half: bool    # stockham: stage one is a radix 2 over a zero upper half
    mirrored: bool     # direct: the table mirrors bin k onto W-k exactly


def _radices(m: int) -> tuple:
    """m, a product of RADICES, as its factors in their order."""
    out = []
    for r in RADICES:
        while m % r == 0:
            out.append(r)
            m //= r
    assert m == 1, m
    return tuple(out)


@functools.lru_cache(maxsize=None)
def fft_plan(W: int) -> FftPlan:
    """The kernel's plan for frames of W samples."""
    if W < 2:
        raise ValueError(f"frames of {W} samples have no bins 1..W-1")
    if W not in FFT_WINDOWS:
        return FftPlan(W, "direct", (), False, _mirrored(_direct_twiddle(W)))
    if W % 2 == 0:
        return FftPlan(W, "stockham", (2, *_radices(W // 2)), True, False)
    return FftPlan(W, "stockham", _radices(W), False, False)


def _direct_twiddle(W: int) -> np.ndarray:
    """The direct sum's [2W, 2] float32 twiddles exp(-2 pi i m / 2W): bins
    0..W of the DFT basis' n = 1 row and their mirror, as dft.dft_matrices
    rounds them."""
    cos_m, sin_m = dft.dft_matrices(W)
    return np.stack([
        np.concatenate([cos_m[1], cos_m[1, 1:W][::-1]]),
        np.concatenate([sin_m[1], -sin_m[1, 1:W][::-1]]),
    ], axis=-1)


def _mirrored(tw: np.ndarray) -> bool:
    """Whether, for every pair the kernel runs (k and W-k, k < W/2) and
    every sample n < W, bin W-k's twiddle entry equals bin k's times
    ((-1)^n, -(-1)^n), as float32 values. Then bin W-k's sum is bin k's
    table read with its signs flipped, and its multiply-adds are the ones
    that read its own entries. (A zero's sign differs at n = 0; it never
    reaches a magnitude.) True at every prime W; false where a k*n lands
    on an entry whose true value is 0 and the table holds a residue, as
    sin(pi) at W = 105 or cos(pi/2) at W = 180."""
    W = tw.shape[0] // 2
    k = np.arange(1, (W - 1) // 2 + 1)[:, None]
    n = np.arange(W)[None, :]
    own, pair = tw[(k * n) % (2 * W)], tw[((W - k) * n) % (2 * W)]
    sign = np.where(n % 2 == 0, 1.0, -1.0).astype(np.float32)
    return bool(np.array_equal(pair[..., 0], sign * own[..., 0])
                and np.array_equal(pair[..., 1], -sign * own[..., 1]))


def radix_code(plan: FftPlan) -> int:
    """The stage radices as the kernel reads them: 4 bits a stage, the
    first stage in the lowest bits (0 for the direct sum)."""
    code = 0
    for i, r in enumerate(plan.radices):
        code |= r << (4 * i)
    return code


def kernel_code(plan: FftPlan) -> int:
    """The plan as csrc/analysis.cu's entry point reads it: the FFT's
    radix_code, or for the direct sum 1 where the table is mirrored and 0
    where each bin of a pair reads its own entries (no radix code is 1)."""
    return radix_code(plan) if plan.route == "stockham" else int(plan.mirrored)


def _complex_f32(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def fft_tables(W: int) -> dict:
    """The plan's tables as [rows, 2] float32 (re, im) arrays: stockham's
    "twiddle" [W] and "post" [W], or direct's "twiddle" [2W]."""
    plan = fft_plan(W)
    if plan.route == "direct":
        tables = {"twiddle": _direct_twiddle(W)}
    else:
        m = np.arange(W)
        tables = {
            "twiddle": _complex_f32(np.exp(-2j * np.pi * m / W)),
            "post": _complex_f32(np.exp(-1j * np.pi * m / W)),
        }
    for t in tables.values():
        t.setflags(write=False)
    return tables


def packed_table(W: int) -> np.ndarray:
    """The tables in the kernel's layout, [2W, 2] float32: stockham's
    twiddles then post-pass turns, or direct's twiddles."""
    return np.ascontiguousarray(np.concatenate(list(fft_tables(W).values())))


# ---------------------------------------------------------------------------
# The float32 model of the kernel's stages
# ---------------------------------------------------------------------------


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _butterfly(vr, vi, R, c, s):
    """The R-point forward DFT along the last axis, in the kernel's
    formulas: radix 2 and 4 by sums, radix 8 as two radix 4 after a
    radix-2 split, an odd radix by the symmetric form with cos c[m] and
    sin s[m] of 2 pi m / R."""
    if R == 8:
        h = c[1]  # cos(pi/4)
        ar = [vr[..., k] + vr[..., k + 4] for k in range(4)]
        ai = [vi[..., k] + vi[..., k + 4] for k in range(4)]
        br = [vr[..., k] - vr[..., k + 4] for k in range(4)]
        bi = [vi[..., k] - vi[..., k + 4] for k in range(4)]
        # b_k times exp(-i pi k / 4): 1, (1 - i)h, -i, -(1 + i)h.
        br[1], bi[1] = h * (br[1] + bi[1]), h * (bi[1] - br[1])
        br[2], bi[2] = bi[2], -br[2]
        br[3], bi[3] = h * (bi[3] - br[3]), -h * (br[3] + bi[3])
        er, ei = _butterfly(torch.stack(ar, -1), torch.stack(ai, -1), 4, c, s)
        orr, oi = _butterfly(torch.stack(br, -1), torch.stack(bi, -1), 4, c, s)
        return ([x for pair in zip(er, orr) for x in pair],
                [x for pair in zip(ei, oi) for x in pair])
    if R == 2:
        return [vr[..., 0] + vr[..., 1], vr[..., 0] - vr[..., 1]], [
            vi[..., 0] + vi[..., 1], vi[..., 0] - vi[..., 1]]
    if R == 4:
        a0r, a0i = vr[..., 0] + vr[..., 2], vi[..., 0] + vi[..., 2]
        a1r, a1i = vr[..., 0] - vr[..., 2], vi[..., 0] - vi[..., 2]
        a2r, a2i = vr[..., 1] + vr[..., 3], vi[..., 1] + vi[..., 3]
        a3r, a3i = vr[..., 1] - vr[..., 3], vi[..., 1] - vi[..., 3]
        return ([a0r + a2r, a1r + a3i, a0r - a2r, a1r - a3i],
                [a0i + a2i, a1i - a3r, a0i - a2i, a1i + a3r])
    H = (R - 1) // 2
    sr = [vr[..., p] + vr[..., R - p] for p in range(1, H + 1)]
    si = [vi[..., p] + vi[..., R - p] for p in range(1, H + 1)]
    dr = [vr[..., p] - vr[..., R - p] for p in range(1, H + 1)]
    di = [vi[..., p] - vi[..., R - p] for p in range(1, H + 1)]
    out_r, out_i = [None] * R, [None] * R
    out_r[0], out_i[0] = vr[..., 0], vi[..., 0]
    for p in range(1, R):
        out_r[0], out_i[0] = out_r[0] + vr[..., p], out_i[0] + vi[..., p]
    for q in range(1, H + 1):
        ar, ai = vr[..., 0], vi[..., 0]
        br = bi = 0.0
        for p in range(1, H + 1):
            m = (p * q) % R
            cm = c[min(m, R - m)]
            sm = s[m] if m <= H else -s[R - m]
            ar, ai = ar + cm * sr[p - 1], ai + cm * si[p - 1]
            br, bi = br + sm * di[p - 1], bi + sm * dr[p - 1]
        out_r[q], out_i[q] = ar + br, ai - bi
        out_r[R - q], out_i[R - q] = ar - br, ai + bi
    return out_r, out_i


def _stage(xr, xi, R, Ns, tw):
    """One Stockham stage over the last axis: butterfly j of the stage
    reads j + r*n/R, turns input r by twiddle (j mod Ns)*r/(Ns*R) of a
    turn, and writes (j - j mod Ns)*R + j mod Ns + r*Ns."""
    n = xr.shape[-1]
    nb = n // R
    j = torch.arange(nb, device=xr.device)
    k = j % Ns
    r = torch.arange(R, device=xr.device)
    src = j[:, None] + r[None, :] * nb
    t = (k[:, None] * r[None, :]) * (n // (Ns * R))
    vr, vi = _cmul(xr[..., src], xi[..., src], tw[t, 0], tw[t, 1])
    roots = tw[r * nb]  # exp(-2 pi i m / R)
    c, s = roots[:, 0], -roots[:, 1]
    wr, wi = _butterfly(vr, vi, R, c, s)
    dst = ((j - k) * R + k)[:, None] + r[None, :] * Ns
    out_r, out_i = torch.empty_like(xr), torch.empty_like(xi)
    out_r[..., dst] = torch.stack(wr, dim=-1)
    out_i[..., dst] = torch.stack(wi, dim=-1)
    return out_r, out_i


def _stages(xr, xi, radices, Ns, tw):
    for R in radices:
        xr, xi = _stage(xr, xi, R, Ns, tw)
        Ns *= R
    return xr, xi


def spectrum_model(frames: torch.Tensor) -> torch.Tensor:
    """frames [F, W] float32 (windowed) -> |X| [F, W], bins 0..W-1, by the
    kernel's plan, tables and stage order in float32, on frames' device."""
    F, W = frames.shape
    dev = frames.device
    plan = fft_plan(W)
    tabs = {k: torch.tensor(v, device=dev) for k, v in fft_tables(W).items()}
    tw = tabs["twiddle"]
    k = torch.arange(W, device=dev)
    if plan.route == "direct":
        # Bin k sums x[n] times twiddle (k*n mod 2W) over n ascending.
        kn = (k[None, :] * k[:, None]) % (2 * W)
        xr, xi = frames @ tw[kn, 0], frames @ tw[kn, 1]
        return torch.sqrt(xr * xr + xi * xi)
    wz = (W + 1) // 2
    pad = torch.cat([frames, frames.new_zeros(F, 2 * wz - W)], dim=1)
    zr, zi = pad[:, 0::2], pad[:, 1::2]  # [F, wz]: z = x[2m] + i x[2m+1]
    grow = lambda a, n: torch.cat([a, a.new_zeros(F, n - wz)], dim=1)
    if plan.zero_half:
        # Stage one, a radix 2 over a zero upper half: each sample twice.
        xr = grow(zr, W // 2).repeat_interleave(2, dim=1)
        xi = grow(zi, W // 2).repeat_interleave(2, dim=1)
        xr, xi = _stages(xr, xi, plan.radices[1:], 2, tw)
    else:
        xr, xi = _stages(grow(zr, W), grow(zi, W), plan.radices, 1, tw)
    wk = (W - k) % W
    ar, ai, br, bi = xr[:, k], xi[:, k], xr[:, wk], xi[:, wk]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    orr, oi = 0.5 * (ai + bi), 0.5 * (br - ar)
    tr, ti = _cmul(tabs["post"][:, 0], tabs["post"][:, 1], orr, oi)
    xr, xi = er + tr, ei + ti
    return torch.sqrt(xr * xr + xi * xi)
