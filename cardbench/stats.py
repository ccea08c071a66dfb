"""Order statistics of a run's samples and of a set of runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    h = (len(xs) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, the quartiles as statistics.quantiles(values, n=4) gives
    them: how the bounds in BENCHMARK.json were set."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
