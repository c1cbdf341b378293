"""The comparison that decides `correct`: the program's answers against the
plain reference's (portbench/reference/plain.py), as numbers each held to a
limit of its own (portbench/limits/<cell>.json).

For every answer compared (a row of a batch step, or a file) it reads
  * the tension, frame by frame;
  * the speeds, frame by frame, relative to the reference's;
  * the output length (valid_length; a file's length, hence its
    achieved_rate);
  * the output audio's error energy over the reference's energy, over the
    longer of the two lengths (each output is zero past its own);
and reduces them to the cell's numbers: the 99.9th percentile over all
frames for the tension and speeds (a few frames at the 40 dB mask's edge
swing by rounding), and the largest over the answers for the length and
the audio, with the audio's median beside it, so that one altered answer
and an error common to all show.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


class Tally:
    """Per-answer readings, gathered block by block."""

    def __init__(self):
        self.tension: List[torch.Tensor] = []
        self.speeds: List[torch.Tensor] = []
        self.length_gap: List[torch.Tensor] = []
        self.err_ratio: List[torch.Tensor] = []

    def add(self, tension, ref_tension, speeds, ref_speeds, out, ref_out, valid, ref_valid):
        """One block of answers: tension and speeds [n, F] (any device),
        outputs [n, >= length] as float full scale 1.0, lengths [n]."""
        cpu = lambda t: t.detach().to("cpu", torch.float64)
        if tension.numel():
            self.tension.append((cpu(tension) - cpu(ref_tension)).abs().flatten())
        rs = cpu(ref_speeds)
        self.speeds.append(((cpu(speeds) - rs).abs() / rs.abs()).flatten())
        v, rv = valid.to("cpu", torch.int64), ref_valid.to("cpu", torch.int64)
        self.length_gap.append((v - rv).abs().to(torch.float64))
        dev = ref_out.device
        n = torch.maximum(v, rv).to(dev)
        width = int(n.max()) if n.numel() else 0
        y = _padded(out.to(dev), width)
        ry = _padded(ref_out, width)
        inside = torch.arange(width, device=dev)[None, :] < n[:, None]
        d = torch.where(inside, (y - ry).abs(), torch.zeros((), device=dev, dtype=y.dtype))
        energy = (ry.double() ** 2).sum(1).clamp(min=1e-30)
        self.err_ratio.append(((d.double() ** 2).sum(1) / energy).cpu())

    def numbers(self) -> Dict[str, float]:
        cat = lambda xs: torch.cat(xs) if xs else torch.zeros(1, dtype=torch.float64)
        p999 = lambda x: float(x.kthvalue(max(1, math.ceil(0.999 * x.numel()))).values)
        err = cat(self.err_ratio)
        return {
            "tension_p999": p999(cat(self.tension)), "speed_p999": p999(cat(self.speeds)),
            "length_gap_max": float(cat(self.length_gap).max()),
            "audio_err_max": float(err.max()), "audio_err_median": float(err.median()),
        }


def _padded(y: torch.Tensor, width: int) -> torch.Tensor:
    if y.shape[1] >= width:
        return y[:, :width].float()
    return torch.nn.functional.pad(y.float(), (0, width - y.shape[1]))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the limits' names: every
    number at or under its limit; a number that is missing or not finite
    fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
