"""The benchmark's arithmetic on times: tails and busy unions.

Frozen here so that a later change to the program cannot change what a
number means.  The busy union is ``repro_torch.launch.trace_analysis
.read_profile``'s, copied.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    at = (len(xs) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def union_length(intervals: Iterable[Interval]) -> float:
    """The length of the union of ``intervals`` (start, end)."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def clipped(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``intervals`` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for start, end in sorted(clipped(intervals, lo, hi)):
        if start > reach:
            out.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        out.append((reach, hi))
    return out
