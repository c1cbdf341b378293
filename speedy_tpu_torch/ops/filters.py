"""First-order IIR lowpass in closed form (port of speedy_tpu/ops/filters.py).

The reference iterates y[t] = α·y[t-1] + (1-α)·x[t] sample by sample
(speedy.c:50-88); the JAX package runs it as an associative scan. PyTorch
has no associative scan, so the recurrence is unrolled in chunks of C
frames:

  inside chunk c:  local[c, i] = Σ_{j<=i} α^(i-j)·(1-α)·x[cC+j]
                   (one product with a [C, C] lower-triangular α-power
                   matrix),
  across chunks:   y[cC+i] = local[c, i] + α^(i+1)·e[c], where e[c] is
                   the filter state entering chunk c:
                   e[c] = α^(cC)·y[-1] + Σ_{c'<c} α^((c-1-c')C)·local[c', C-1]
                   (one product with an [nC, nC] matrix).

Powers are taken in float64 and cast once; everything else is float32.
The tables and α go to the device once per (α, nC) (trace.upload_once).
Summation order differs from the scan, so results agree to float32
round-off (held to the 2e-5 tension gate in tests/test_torch_frontend.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace

_CHUNK = 64


@functools.lru_cache(maxsize=8)
def _power_matrices(alpha: float, n_chunks: int):
    a = np.float64(alpha)
    i = np.arange(_CHUNK)
    d = i[:, None] - i[None, :]
    within = np.where(d >= 0, a ** np.maximum(d, 0), 0.0)  # [C, C]
    lead = a ** (i + 1.0)  # [C]: α^(i+1)
    c = np.arange(n_chunks)
    dc = c[:, None] - 1 - c[None, :]
    across = np.where(dc >= 0, (a**_CHUNK) ** np.maximum(dc, 0), 0.0)  # [nC, nC]
    init = (a**_CHUNK) ** c  # [nC]: α^(cC)
    return within, lead, across, init


def first_order_lowpass(
    x: torch.Tensor, alpha: float, initial_state: float
) -> torch.Tensor:
    """y[t] = α·y[t-1] + (1-α)·x[t] along the last axis of x [..., T],
    with y[-1] = initial_state (IterateFirstOrderFilter, speedy.c:73-76,
    seeded via SetFirstOrderFilterState, speedy.c:82-84,287-292)."""
    T = x.shape[-1]
    if T == 0:
        return x.clone()
    lead_shape = x.shape[:-1]
    x = x.reshape(-1, T)
    B = x.shape[0]
    nC = -(-T // _CHUNK)
    dt, dev = x.dtype, x.device
    key = (float(alpha), nC)
    within, lead, across, init = (
        trace.upload_once("lpf_tables", m, dt, dev, key=key + (i,))
        for i, m in enumerate(_power_matrices(*key))
    )
    a = trace.upload_once("lpf_alpha", float(alpha), dt, dev)
    b = (1.0 - a) * x
    if nC * _CHUNK != T:
        b = torch.cat([b, b.new_zeros(B, nC * _CHUNK - T)], dim=1)
    local = torch.matmul(b.view(B, nC, _CHUNK), within.T)  # [B, nC, C]
    enter = torch.matmul(local[:, :, -1], across.T) + init * initial_state
    y = local + lead * enter[:, :, None]
    return y.reshape(B, nC * _CHUNK)[:, :T].reshape(lead_shape + (T,))
