"""Which stage of kernel 3's body costs the time on the H100, and what share
is the span's bytes?

Port of experiments/synth_bisect.py through kernel 11
(kernels.synth_bisect, csrc/synth_bisect.cu): kernel 3's body stopped
after each stage, the span copy (dma), the one-hot row select (onehot),
the barrel shift (barrel), interpolation and window (interp) and the
overlap-add (full), at a span plan of 6.0x (122,880 samples), then full at
4.0x (81,920: the narrow span). The experiment's shape, as
gather_bisect's: 16 kHz, B = 128 utterances of 161,304 samples, K = 1,009
chunks at hop 160 every 3.51 hops, 286 live (3 of 8 blocks of 128), and
uniform fractions af (seed 0).

    python -m speedy_tpu_torch.experiments.synth_bisect [--device cuda]

Prints one JSON line a stage: its launches, its difference from the plain
version, and on the card the median ms of a call by CUDA events and the
device ms of the kernel (torch.profiler), each with its increment over the
row before, and the plain version's ms. full is also held to kernel 3's
plain version (kernels.gather_synth_reference, gain 1) on the lanes below
hop of the live rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, wsola_fast
from . import add_increments, covered, device_ms, launched, probe_device, require, run_main, time_ms
from .gather_bisect import BATCH, R, plan, signal, span_plan, starts_n_valid

STAGES = kernels.SYNTH_BISECT_STAGES
EXACT = STAGES  # the kernel does the plain version's float32 operations in its order
CASES = tuple((stage, 6.0) for stage in STAGES) + (("full", 4.0),)  # synth_bisect.py:214-218


def slots(out: torch.Tensor, K: int) -> torch.Tensor:
    """[B, NB, R * ts, 128] T-major slabs -> [B, K, ts * 128]: row k = nb*R
    + r holds slot k's samples j = t*128 + l."""
    B, NB, ST, lanes = out.shape
    ts = ST // R
    return out.reshape(B, NB, ts, R, lanes).transpose(2, 3).reshape(B, NB * R, ts * lanes)[:, :K]


def read_words(stage: str, x, starts, n_valid, hop: int) -> int:
    """The words a stage's function must read, each once: the starts and
    n_valid (interp and full: also af and the window), and the samples of x
    the live blocks' rows come from: dma, each span's first R * ts rows;
    onehot, the rows q8 + t; barrel, x[s : s + ts * 128]; interp, the
    window's part of that and one sample more; full, that and the row
    before's samples from hop on, where it has a window."""
    B, L = x.shape
    K = starts.shape[1]
    ts = -(-hop // kernels.LANES)
    span = ts * kernels.LANES  # samples of a row's first ts tiles
    total = B * kernels.padded_len(L)  # x's part of the flat view
    offs, first, nvb = kernels.bisect_span_geometry(starts, n_valid, R, L)
    NB = offs.shape[1]
    live = torch.arange(NB, device=x.device)[None, :] < nvb[:, None]
    s = (first[..., None] + offs).reshape(B, NB * R)  # each row's start in the flat view
    live_rows = live.repeat_interleave(R, dim=1)
    m = min(span, 2 * hop)
    if stage == "dma":
        samples = covered(first[live], R * span, total)
    elif stage == "onehot":
        q8 = (first[..., None] + offs // kernels.LANES * kernels.LANES).reshape(B, NB * R)
        samples = covered(q8[live_rows], span, total)
    elif stage in ("barrel", "interp"):
        samples = covered(s[live_rows], span if stage == "barrel" else m + 1, total)
    else:
        has_prev = live_rows[:, 1:]  # row k > 0 adds row k - 1's samples from hop
        prev = s[:, :-1][has_prev] + hop
        firsts = torch.cat([s[live_rows], prev])
        ends = torch.cat([s[live_rows] + m + 1, s[:, :-1][has_prev] + min(hop + span, 2 * hop) + 1])
        samples = covered(firsts, ends - firsts, total)
    extra = B * K + 2 * hop if stage in ("interp", "full") else 0
    return samples + B * K + B + extra


def check(device="cuda") -> list:
    """Every case once through kernel 11 (the answer pass), each held to
    its plain version, bitwise at every stage; full held to kernel 3's
    plain version within 1e-6 on the lanes below hop of the live rows;
    then on the card the times. One row a case."""
    device = probe_device(device)
    p = plan()
    hop, K = p["hop"], p["K"]
    rng = np.random.default_rng(0)
    af = torch.as_tensor(rng.uniform(0, 1, (BATCH, K)).astype(np.float32), device=device)
    x = signal(rng, p, device)  # synth_bisect.py:184-190: af drawn first
    starts, n_valid = starts_n_valid(p, device)
    kw = lambda speed: dict(hop=hop, rows_per_block=R, w_span=span_plan(p, speed))
    call = lambda stage, speed: kernels.synth_bisect(x, starts, af, n_valid, stage, **kw(speed))
    plain = lambda stage, speed: kernels.synth_bisect_reference(x, starts, af, n_valid, stage,
                                                                **kw(speed))
    answer = [launched("synth_bisect", lambda: call(*case)) for case in CASES]

    # Kernel 3's slots, gain 1 and no valid-length mask, where its zero
    # outside [0, L) and the flat view agree: rows whose window lies in x.
    win = torch.as_tensor(wsola_fast._cola_hann(2 * hop), device=device)
    ones = torch.ones(x.shape[0], device=device)
    full_len = torch.full((x.shape[0],), K * hop, dtype=torch.int32, device=device)
    kernel3 = kernels.gather_synth_reference(x, starts, af, win, ones, full_len, hop,
                                             K * hop).reshape(-1, K, hop)
    _, _, nvb = kernels.bisect_span_geometry(starts, n_valid, R, x.shape[1])
    rows_live = (torch.arange(K, device=device)[None, :] < nvb[:, None] * R) & (
        starts.long() + 2 * hop + 1 < x.shape[1])

    rows = []
    for (stage, speed), (out, n) in zip(CASES, answer):
        ref = plain(stage, speed)
        d = float((out - ref).abs().max())
        if stage in EXACT:
            require(torch.equal(out, ref), stage, speed, "kernel 11 against its plain version", d)
        require(d <= 1e-6, stage, speed, "kernel 11 against its plain version", d)
        del ref
        d3 = None
        if stage == "full":
            got = slots(out, K)[..., :hop]
            d3 = float((got - kernel3).abs()[rows_live].max())
            require(d3 <= 1e-6, speed, "full against kernel 3's plain version", d3)
            del got
        del out
        rows.append(dict(
            probe="synth_bisect", stage=stage, max_speed=speed, B=x.shape[0], L=x.shape[1], K=K,
            hop=hop, R=R, w_span=span_plan(p, speed), n_valid=int(n_valid[0]), launches=n,
            max_abs_err=d, kernel3_max_abs_err=d3,
            out_words=x.shape[0] * -(-K // R) * R * -(-hop // kernels.LANES) * kernels.LANES,
            read_words=read_words(stage, x, starts, n_valid, hop),
            ms=time_ms(lambda: call(stage, speed), device),
            device_ms=device_ms(lambda: call(stage, speed), device),
            plain_ms=time_ms(lambda: plain(stage, speed), device), library_ms=None))
    return add_increments(rows)


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
