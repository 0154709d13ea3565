"""The percentiles of a window's samples, in pure Python, so that the arithmetic stays the same
whichever numpy a machine has."""
from __future__ import annotations

__all__ = ["percentile"]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the closest ranks
    (numpy's default ``"linear"`` method): rank ``q / 100 * (n - 1)`` of the sorted values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    rank = q / 100.0 * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)

