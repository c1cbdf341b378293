"""Tapered-max temporal hysteresis (port of speedy_tpu/ops/hysteresis.py).

The reference keeps a 42-slot ring buffer and, per queried frame, scans
kTemporalHysteresisFuture forward and kTemporalHysteresisPast backward with
triangular tapers, averaging the two maxima (speedy.c:587-619). Here each
tap is one shifted slice of the whole [..., T] sequence. Reads outside
[0, T) are 0: the reference's ring is zero-initialised and a valid query
never reaches an overwritten slot (speedy.c:95).
"""

from __future__ import annotations

import torch


def _shifted(values: torch.Tensor, shift: int, num_out: int) -> torch.Tensor:
    """[..., num_out] with out[t] = values[t + shift], 0 outside [0, T): a
    view when every read is in range, else one padding copy."""
    T = values.shape[-1]
    lo, hi = max(0, -shift), min(num_out, T - shift)
    if hi <= lo:
        return values.new_zeros(values.shape[:-1] + (num_out,))
    window = values[..., lo + shift : hi + shift]
    if lo == 0 and hi == num_out:
        return window
    return torch.nn.functional.pad(window, (lo, num_out - hi))


def tapered_max_hysteresis(
    values: torch.Tensor, future: int, past: int, num_out: int
) -> torch.Tensor:
    """speedyEvaluateHysteresis for t = 0..num_out-1 over values [..., T]:
    (max_i taper_f(i)·v[t+i] + max_i taper_p(i)·v[t-i]) / 2 with
    taper_f(i) = (future-i)/future over i = 0..future (speedy.c:595-601)
    and taper_p(i) = (past-i)/past over i = 0..past (speedy.c:602-608).
    Maxima are clamped at 0 (the accumulators start at 0.0,
    speedy.c:594)."""
    # A Python float taper is rounded to the tensor's float32 before the
    # product, as the JAX package's float32 taper array is.
    future_max = values.new_zeros(values.shape[:-1] + (num_out,))
    for i in range(future + 1):
        taper = (future - i) / float(future)
        future_max = torch.maximum(future_max, _shifted(values, i, num_out) * taper)
    past_max = values.new_zeros(values.shape[:-1] + (num_out,))
    for i in range(past + 1):
        taper = (past - i) / float(past)
        past_max = torch.maximum(past_max, _shifted(values, -i, num_out) * taper)
    return (past_max + future_max) / 2.0
