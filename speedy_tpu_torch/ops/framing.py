"""Analysis frame positions (the port's copy of speedy_tpu/ops/framing.py's
frame_starts; the batched front-end builds frames from strided views)."""

from __future__ import annotations

import numpy as np

from ..config import SpeedyConfig


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
