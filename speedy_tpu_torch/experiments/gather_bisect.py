"""Which stage of kernel 5's body costs the time on the H100?

Port of experiments/gather_bisect.py through kernel 10
(kernels.gather_bisect, csrc/gather_bisect.cu): kernel 5's body stopped
after each stage, the span copy (dma), the one-hot row select (onehot) and
the barrel shift (full, kernel 5's function), at the experiment's shape:
16 kHz, B = 128 utterances of 161,304 samples (10 s padded as the unfused
synthesis pads them), K = 1,009 rows of 321 starting every 3.51 hops, 286
live (3 of 8 blocks of 128 rows), a span plan of 122,880 samples (6.0x).

    python -m speedy_tpu_torch.experiments.gather_bisect [--device cuda]

Prints one JSON line a stage: its launches, its difference from the plain
version (none: every stage is a copy), and on the card the median ms of a
call by CUDA events and the device ms of the kernel (torch.profiler), each
with its increment over the stage before, the plain version's ms, and for
full the library gather's (x.unfold(1, width, 1) indexed by the starts).
full is also held, bitwise on the live rows, to kernel 5
(kernels.gather_rows_block).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SpeedyConfig
from ..ops import kernels, wsola, wsola_fast
from . import (add_increments, covered, device_ms, launched, probe_device, require, run_main,
               time_ms)

SR, BATCH, SECONDS = 16000, 128, 10  # experiments/gather_bisect.py:12
R = 128
RATE_STEP = 3.51  # the starts' step in hops (:105)
MAX_SPEED_PLAN = 6.0
STAGES = kernels.GATHER_BISECT_STAGES


def plan() -> dict:
    """The experiment's geometry (gather_bisect.py:12-23): hop, K, the
    padded length Lp, pad_front = max period, width = 2 * hop + 1."""
    cfg = SpeedyConfig(SR)
    L = SR * SECONDS
    _, maxp, _, _ = wsola.plan(cfg, L, 1.0)
    hop, _, K = wsola_fast.plan_grid(cfg, L, 1.0)
    return dict(L=L, hop=hop, K=K, maxp=maxp, width=2 * hop + 1,
                Lp=L + maxp + 2 * maxp + maxp + 2 * hop)


def span_plan(p: dict, max_speed: float) -> int:
    """w_span: the span R rows need at max_speed, in multiples of 1024
    (gather_bisect.py:19-20)."""
    need = (R - 1) * int(np.ceil(p["hop"] * max_speed)) + p["maxp"] + p["width"] + 32
    return -(-need // 1024) * 1024


def starts_n_valid(p: dict, device):
    """starts [BATCH, K] int32, every RATE_STEP hops clipped to the signal
    and offset by pad_front, and n_valid [BATCH] int32
    (gather_bisect.py:105-108)."""
    L, hop, K = p["L"], p["hop"], p["K"]
    c = np.cumsum(np.full((BATCH, K), hop * RATE_STEP), axis=1).astype(np.float32)
    a_i = np.clip(c.astype(np.int32), 0, L - 1) + p["maxp"]
    n_valid = np.full((BATCH,), int(L / RATE_STEP / hop) + 2, np.int32)
    return (torch.as_tensor(a_i.astype(np.int32), device=device),
            torch.as_tensor(n_valid, device=device))


def signal(rng, p: dict, device) -> torch.Tensor:
    """x [BATCH, Lp]: the experiment's fresh() (gather_bisect.py:101-102)."""
    x = rng.standard_normal((BATCH, p["Lp"])).astype(np.float32) * 0.1
    return torch.as_tensor(x, device=device)


def read_words(stage: str, x, starts, n_valid, width: int, w_span: int) -> int:
    """The words a stage's function must read, each once: the starts and
    n_valid, and the samples of the flat view that the live blocks' output
    rows come from (dma: the slab rows r*nt + t of the span; onehot: span
    rows q8[r] + t; full: x[b, s : s + width])."""
    B, L = x.shape
    K = starts.shape[1]
    nt = kernels.bisect_tiles(width)
    w_rows = kernels.bisect_w_rows(w_span, nt)
    offs, first, nvb = kernels.bisect_span_geometry(starts, n_valid, R, L)
    NB = offs.shape[1]
    live = (torch.arange(NB * R, device=x.device) < K).reshape(1, NB, R) & (
        torch.arange(NB, device=x.device)[None, :, None] < nvb[:, None, None])
    total = B * kernels.padded_len(L)  # x's part of the flat view
    if stage == "full":
        samples = covered((first[..., None] + offs)[live], width, total)
    else:
        t = torch.arange(nt, device=x.device)
        t = t[t * kernels.LANES < width]
        lanes = (width - t * kernels.LANES).clamp(max=kernels.LANES)  # [tiles]
        r = torch.arange(R, device=x.device)
        rows = (r[:, None] * nt + t if stage == "dma" else offs[..., None] // kernels.LANES + t)
        rows = rows.expand(B, NB, R, t.numel())
        ok = live[..., None] & (rows < w_rows)
        pos = first[..., None, None] + rows * kernels.LANES
        samples = covered(pos[ok], lanes.expand_as(pos)[ok], total)
    return samples + B * K + B


def check(device="cuda") -> list:
    """Every stage once through kernel 10 (the answer pass), each held
    bitwise to its plain version; full held bitwise to kernel 5 on the live
    rows; then on the card the times. One row a stage."""
    device = probe_device(device)
    p = plan()
    width, K = p["width"], p["K"]
    w_span = span_plan(p, MAX_SPEED_PLAN)
    kw = dict(width=width, rows_per_block=R, w_span=w_span)
    x = signal(np.random.default_rng(0), p, device)
    starts, n_valid = starts_n_valid(p, device)
    call = lambda stage: kernels.gather_bisect(x, starts, n_valid, stage, **kw)
    plain = lambda stage: kernels.gather_bisect_reference(x, starts, n_valid, stage, **kw)
    answer = {stage: launched("gather_bisect", lambda: call(stage)) for stage in STAGES}

    rows = []
    for stage in STAGES:
        out, n = answer.pop(stage)
        ref = plain(stage)
        d = float((out - ref).abs().max())
        require(torch.equal(out, ref), stage, "kernel 10 against its plain version", d)
        if stage == "full":
            nv = int(n_valid.min())
            prod = kernels.gather_rows_block(x, starts, width, R, w_span, n_valid)
            require(torch.equal(out[:, :nv], prod[:, :nv]), "full against kernel 5 on live rows")
            del prod
        del out, ref
        lib = None
        if stage == "full":
            b = torch.arange(x.shape[0], device=device)[:, None]
            lib = lambda: x.unfold(1, width, 1)[b, starts.long()]
        rows.append(dict(
            probe="gather_bisect", stage=stage, B=x.shape[0], L=x.shape[1], K=K, width=width,
            R=R, w_span=w_span, n_valid=int(n_valid[0]), launches=n, max_abs_err=d,
            out_words=x.shape[0] * K * width,
            read_words=read_words(stage, x, starts, n_valid, width, w_span),
            ms=time_ms(lambda: call(stage), device),
            device_ms=device_ms(lambda: call(stage), device),
            plain_ms=time_ms(lambda: plain(stage), device),
            library_ms=None if lib is None else time_ms(lib, device)))
    return add_increments(rows)


def main(argv=None) -> int:
    return run_main(__doc__, check, argv)


if __name__ == "__main__":
    raise SystemExit(main())
