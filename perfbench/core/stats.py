"""The arithmetic of the end-to-end metrics: rates over a window and
percentiles over every sample in it, stalls included."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the smallest value with at least q % of them at or below
    it. Every sample counts, a stall as much as any other."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(units: float, seconds: float) -> float:
    """Units completed per second of the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds
