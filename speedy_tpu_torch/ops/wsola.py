"""WSOLA result type and static planning (port of the planning half of
speedy_tpu/ops/wsola.py; the sequential scan engine is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SpeedyConfig


class WsolaResult(NamedTuple):
    output: torch.Tensor        # [B, capacity] (zero beyond valid_length)
    valid_length: torch.Tensor  # [B] int32
    steps_used: torch.Tensor    # [B] int32 (diagnostics)


def plan(cfg: SpeedyConfig, input_len: int, min_speed_bound: float):
    """Static capacity / trip-count planning for a given input length.

    `min_speed_bound` must lower-bound every speed the engine will see; it
    sizes the fixed output buffer and the scan trip count.
    Returns (min_period, max_period, capacity, num_steps).
    """
    minp, maxp = cfg.wsola_min_period, cfg.wsola_max_period
    capacity = int(np.ceil(input_len / max(min_speed_bound, 0.01))) + 4 * maxp
    if min_speed_bound >= 1.0:
        min_consumed = minp + 1
    else:
        s = min(min_speed_bound, 0.5)
        min_consumed = max(1, int(minp * s / (1.0 - s)))
        min_consumed = min(min_consumed, minp + 1)
    num_steps = int(np.ceil(input_len / min_consumed)) + 8
    # Bucket the static sizes so nearby inputs share one plan.
    capacity = -(-capacity // 8192) * 8192
    num_steps = -(-num_steps // 512) * 512
    return minp, maxp, capacity, num_steps
