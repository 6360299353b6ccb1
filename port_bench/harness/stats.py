"""Rate, percentile and spread arithmetic: the benchmark's own copies,
so that no change to the program moves the yardstick."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(count: int, seconds: float) -> float:
    """Work completed over the window's seconds: all of it, over all of it."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value with at least
    p percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    if not 0 < p <= 100:
        raise ValueError("p lies in (0, 100]")
    ordered = sorted(values)
    return float(ordered[max(1, math.ceil(p / 100.0 * len(ordered))) - 1])


def median(values: Sequence[float]) -> float:
    return float(statistics.median(values))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile, as
    statistics.quantiles(values, n=4) gives them, over the median."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
