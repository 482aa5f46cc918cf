"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolated linearly between the
    two nearest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def rate(events, start: float, deadline: float) -> tuple[float, int, float]:
    """Work done per second over a window: ``events`` are (time, work) pairs, the time a
    result reached the host and the work it completed. Every event at or before
    ``deadline`` counts, and the window runs from ``start`` to the last of them.
    Returns (rate, work, seconds)."""
    done = [(t, w) for t, w in events if t <= deadline]
    if not done:
        raise ValueError("no work completed inside the window")
    seconds = max(t for t, _ in done) - start
    work = sum(w for _, w in done)
    return work / seconds, work, seconds
