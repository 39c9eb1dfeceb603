"""The statistics the metrics are taken with."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the two nearest ranks
    (numpy's default): over every value, none left out."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The intervals clipped to ``[lo, hi]`` and merged where they
    overlap or touch, in order."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that the merged ``busy`` intervals
    leave free."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_share(intervals: Iterable[Tuple[float, float]], lo: float,
               hi: float) -> float:
    """1 - the union of ``intervals`` inside ``[lo, hi]`` over its
    length."""
    busy = sum(b - a for a, b in union(intervals, lo, hi))
    return 1.0 - busy / (hi - lo)
