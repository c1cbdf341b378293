"""Kernel 3's plan: how csrc/synth.cu cuts the fused synthesis into
blocks, what each block stages in shared memory, and a float32 model that
walks that plan with PyTorch.

Output sample s = k*hop + j of row b belongs to slot k. A block takes one
row b and a run of S consecutive slots k0 .. k0+S-1 (the last run of a row
may be short), so a row has ceil(ceil(capacity / hop) / S) runs. S comes
from B, hop and the slot count alone (synth_plan): the largest S up to
RUN_MAX that still gives each of the H100's 132 SMs two blocks and
WARPS_PER_SM warps, so a single long utterance (B = 1) spreads over the
card as a batch does. A block has a thread per offset j of a slot (hop
rounded up to whole warps), so at a small hop a block has few warps, and
its S slots run one after another in each thread: there S is cut further,
until enough blocks are resident to hide shared memory's and the copies'
latency.

A run's slots read chunks k0-1 .. k0+S-1, chunk c's samples
x[a_i[c] .. a_i[c] + 2*hop] (raw_c[j] interpolates x[a+j] and x[a+j+1]).
Slot k reads the first half of chunk k and the second half of chunk k-1,
so the block stages only the halves its live slots read: chunk k0-1's
second half, chunk k0+S-1's first half, both halves of those between,
and nothing for a slot at or past valid[b]. Each staged span starts at the
16-byte-aligned address at or below x + a_i[c] + lo (its first sample),
so it is copied in whole 16-byte granules, and reads 0 wherever it lies
outside [0, L): the kernel's math then reads no branches. A run that starts
at or past valid[b] stages nothing and stores zeros.

gather_synth_model() computes the kernel's function on that plan: the
same spans, aligned down from the tensor's own address, zero-filled past
either end of the row, NaN wherever the plan stages nothing (a read the
plan does not cover then shows as NaN), and the same float32 operations
in the same order as kernels.gather_synth_reference. It is a test oracle
for the plan's index arithmetic (tests/test_torch_synth_model.py) and, on
the card, for the kernel (chip_smoke.py holds kernel 3 equal to it); no
path of the port calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

SMS = 132  # the H100 SXM's streaming multiprocessors
WARPS_PER_SM = 12  # warps an SM should hold at least, where the slots allow
RUN_MAX = 16  # slots a block at most (kRunMax in csrc/synth.cu)
THREADS_MAX = 512  # threads a block at most (kThreadsMax)
OFFSETS_MAX = 4  # offsets j a thread at most (kOffsetsMax): hop <= 2,048
SHARED_OPTIN = 232_448  # shared memory a block may be granted on the H100
STATIC_SHARED = (RUN_MAX + 1) * 24  # a span (8 B) and the controls (16 B) a chunk


class SynthPlan(NamedTuple):
    run: int  # S, output slots a block
    runs: int  # blocks a row
    slots: int  # ceil(capacity / hop)
    threads: int  # a block's threads; thread t owns offsets t, t + threads, ...
    stride: int  # floats between two staged chunk spans
    shared_bytes: int  # dynamic shared memory a block: the run + 1 spans


def span_stride(hop: int) -> int:
    """Floats a staged chunk span may take: 2*hop + 1 samples and up to 3
    in front of them from aligning down, rounded up to whole granules."""
    return (2 * hop + 4 + 3) // 4 * 4


def _shared_bytes(hop: int, run: int) -> int:
    return 4 * (run + 1) * span_stride(hop)


@functools.lru_cache(maxsize=256)
def synth_plan(B: int, hop: int, capacity: int) -> SynthPlan:
    """The plan of one launch over [B, capacity]: S from B * slots (at
    least two blocks and WARPS_PER_SM warps an SM where the slots allow, at
    most RUN_MAX), cut further only if its shared memory would not fit a
    block."""
    slots = -(-capacity // hop)
    threads = min(-(-hop // 32) * 32, THREADS_MAX)
    blocks_per_sm = max(2, -(-WARPS_PER_SM * 32 // threads))
    run = max(1, min(RUN_MAX, B * slots // (blocks_per_sm * SMS)))
    while run > 1 and _shared_bytes(hop, run) + STATIC_SHARED > SHARED_OPTIN:
        run -= 1
    return SynthPlan(run, -(-slots // run), slots, threads, span_stride(hop),
                     _shared_bytes(hop, run))


class Spans(NamedTuple):
    """What each block stages, [B, runs, S + 1] for its chunks k0-1+i."""

    chunk: torch.Tensor  # c = k0 - 1 + i (int64)
    first: torch.Tensor  # slot c is live: its first half is staged
    second: torch.Tensor  # slot c + 1 is live and in the run: its second half
    base: torch.Tensor  # row index of the span's first staged float (aligned)
    granules: torch.Tensor  # 16-byte granules staged (0: none)
    off: torch.Tensor  # a_i[c] - base: where x[a_i[c]] sits in the span


def staged_spans(x, a_i, valid, hop: int, capacity: int, plan: SynthPlan) -> Spans:
    """The spans the kernel stages for x [B, L] and a_i [B, K], with their
    alignment taken from x's own address."""
    B, L = x.shape
    K = a_i.shape[1]
    S, dev = plan.run, x.device
    k0 = torch.arange(plan.runs, device=dev) * S  # [R]
    s1 = torch.clamp((k0 + S) * hop, max=capacity)
    vend = torch.minimum(valid.long()[:, None], s1[None])  # [B, R]
    live = vend > (k0 * hop)[None]  # not a run of zeros
    i = torch.arange(S + 1, device=dev)
    chunk = k0[:, None] - 1 + i[None]  # [R, S+1]
    vend3 = vend[:, :, None]
    first = live[:, :, None] & (i >= 1) & (chunk * hop < vend3)
    second = live[:, :, None] & (chunk >= 0) & (i < S) & ((chunk + 1) * hop < vend3)
    a = a_i.long().gather(1, chunk.clamp(0, K - 1).reshape(1, -1).expand(B, -1))
    a = a.reshape(B, plan.runs, S + 1)
    lo = torch.where(first, 0, hop)
    hi = torch.where(second, 2 * hop, hop)
    # Each row's first float sits mis floats past a 16-byte boundary.
    mis = (x.data_ptr() // 4 + torch.arange(B, device=dev) * L) % 4
    mis = mis[:, None, None]
    base = torch.bitwise_and(a + lo + mis, -4) - mis
    granules = torch.where(first | second, (a + hi - base + 4) // 4, 0)
    return Spans(chunk.expand(B, -1, -1), first, second, base, granules, a - base)


def gather_synth_model(
    x: torch.Tensor,
    a_i: torch.Tensor,
    a_f: torch.Tensor,
    win: torch.Tensor,
    gain: torch.Tensor,
    valid: torch.Tensor,
    hop: int,
    capacity: int,
) -> torch.Tensor:
    """kernels.gather_synth's function computed on the kernel's plan:
    [B, capacity] from the staged spans, in the plain version's order of
    float32 operations."""
    B, L = x.shape
    K = a_i.shape[1]
    plan = synth_plan(B, hop, capacity)
    S, R, W, dev = plan.run, plan.runs, plan.stride, x.device
    sp = staged_spans(x, a_i, valid, hop, capacity, plan)

    # The staged spans [B, R, S+1, W]: 0 outside the row, NaN unstaged.
    e = torch.arange(W, device=dev)
    q = sp.base[..., None] + e
    inside = (q >= 0) & (q < L)
    rows = x.gather(1, q.clamp(0, L - 1).reshape(B, -1)).reshape(q.shape)
    xs = torch.where(inside, rows, torch.zeros((), dtype=x.dtype, device=dev))
    staged = e < 4 * sp.granules[..., None]
    xs = torch.where(staged, xs, torch.full((), float("nan"), dtype=x.dtype, device=dev))

    c = sp.chunk.clamp(0, K - 1).reshape(B, -1)
    f = a_f.gather(1, c).reshape(B, R, S + 1)
    omf = 1.0 - f
    j = torch.arange(hop, device=dev)

    def raw(i: slice, jj: torch.Tensor) -> torch.Tensor:
        """raw_c[jj] of the chunks i of every run, [B, R, S, hop]:
        x0*(1-f) + x1*f from the staged span, NaN for a read past it."""
        idx = sp.off[:, :, i, None] + jj
        ok = (idx >= 0) & (idx + 1 < W)
        span = xs[:, :, i]
        x0 = span.gather(-1, idx.clamp(0, W - 1))
        x1 = span.gather(-1, (idx + 1).clamp(0, W - 1))
        nan = torch.full((), float("nan"), dtype=x.dtype, device=dev)
        x0, x1 = torch.where(ok, x0, nan), torch.where(ok, x1, nan)
        return x0 * omf[:, :, i, None] + x1 * f[:, :, i, None]

    r1 = raw(slice(1, S + 1), j)  # slot k's chunk k, first half
    r2 = raw(slice(0, S), hop + j)  # chunk k-1, second half
    v = r1 * win[:hop] + r2 * win[hop:]
    s = (torch.arange(R * S, device=dev).reshape(R, S, 1)) * hop + j  # [R, S, hop]
    v = torch.where(s < hop, r1, v)  # slot 0: no partner, no window
    out = (v * gain[:, None, None, None]).reshape(B, R * S * hop)[:, :capacity]
    keep = torch.arange(capacity, device=dev)[None, :] < valid[:, None]
    return torch.where(keep, out, torch.zeros((), dtype=x.dtype, device=dev))
