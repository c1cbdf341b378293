"""The window's tail over every call. Plain Python, no dependencies."""

from __future__ import annotations

import math
from typing import Sequence


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of all values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
