"""Framing and preemphasis (port of speedy_tpu/ops/framing.py).

The reference carries preemphasis state across 50%-overlapped frames
(speedy.c:416-425,540-551: the state entering frame t is the *raw* last
sample of frame t-1). That state is a gather from the input waveform, so
the whole stage is data-parallel over frames. Every function here works
along the last axis of x, [L] or [B, L].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..config import PREEMPHASIS_COEF, SpeedyConfig


def frame_starts(cfg: SpeedyConfig, num_frames: int, integer_step: bool = False) -> np.ndarray:
    """Start index of each analysis frame.

    Float-step mode replicates `(int)std::round(t * stepSize)` from the
    reference harness (speedy_test.cc:558,912) — round half away from zero.
    Integer-step mode replicates the sonic2 shim's contiguous 1/frameRate
    buffers (soniclib.c:195,265-287: frame k covers [k*step, k*step+window)).
    """
    t = np.arange(num_frames, dtype=np.float64)
    if integer_step:
        return (t.astype(np.int64) * cfg.frame_step_int).astype(np.int32)
    return np.floor(t * cfg.frame_step_float + 0.5).astype(np.int32)


def extract_frames(x: torch.Tensor, starts: torch.Tensor, window_size: int) -> torch.Tensor:
    """Overlapping frames x[..., L] -> [..., T, W], indices clamped to
    [0, L) (jnp.take mode="clip")."""
    idx = starts.to(x.device, torch.int64)[:, None] + torch.arange(
        window_size, device=x.device
    )
    return x[..., idx.clamp(0, x.shape[-1] - 1)]


def preemphasis_state(x: torch.Tensor, starts: torch.Tensor, window_size: int) -> torch.Tensor:
    """Raw sample carried into each frame's preemphasis, [..., T] (0 for
    frame 0): x[start[t-1] + W - 1], the last raw sample of frame t-1
    (speedy.c:422-423), not x[start[t] - 1]."""
    prev_idx = starts.to(x.device, torch.int64)[:-1] + (window_size - 1)
    prev = x[..., prev_idx.clamp(0, x.shape[-1] - 1)]
    return torch.cat([x.new_zeros(x.shape[:-1] + (1,)), prev], dim=-1)


def preemphasize(frames: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """y[i] = x[i] - 0.97 * x[i-1] within each frame of frames [..., T, W],
    with the carried state [..., T] as x[-1] (filter([1 -0.97], 1, x),
    speedy.c:416-425)."""
    prev = torch.cat([state[..., None], frames[..., :-1]], dim=-1)
    coef = trace.upload("preemphasis_coef", PREEMPHASIS_COEF, dtype=frames.dtype,
                        device=frames.device)
    return frames - coef * prev
