"""Percentiles and spreads, frozen with the benchmark."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of ``values``: the
    smallest value with at least q % of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``, the exclusive method)."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    median = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - median))
    return [v for i, v in enumerate(values) if i != far]
