"""Order statistics of the harness."""
from __future__ import annotations

import numpy as np


def percentile(values, p: float) -> float | None:
    """The p-th percentile, linearly interpolated between order
    statistics (numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), p))


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals) -> list:
    """The (start, end) intervals merged where they overlap, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out
