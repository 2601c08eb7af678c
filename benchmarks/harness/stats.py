"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math
import statistics


def percentile(xs, q: float) -> float:
    """The q-th percentile of xs by nearest rank: the smallest sample
    with at least q % of the samples at or below it."""
    ys = sorted(xs)
    if not ys:
        raise ValueError("percentile of no samples")
    return ys[min(len(ys) - 1, max(0, math.ceil(q / 100 * len(ys)) - 1))]


def spread(xs) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(xs, n=4)``)."""
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med
