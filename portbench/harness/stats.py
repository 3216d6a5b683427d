"""Arithmetic of the end-to-end metrics and of the spreads."""

from __future__ import annotations

import statistics


def rate(count: int, seconds: float) -> float:
    """Units completed per second over the whole window."""
    return count / seconds


def spread(values) -> float:
    """Interquartile distance as a share of the median (Python's quartiles)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def merge_spans(spans):
    """The union of ``(start, end)`` intervals as sorted disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
