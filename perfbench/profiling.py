"""A ``torch.profiler`` run read into device kernels, host ops and the harness's ranges.

The profiler's host and device events share one clock (microseconds from
its start).  The harness marks what it drives with ``record_function``
ranges named ``perfbench.*``; a stretch of the trace is read between such
marks.  Busy time is the union of the device events' intervals
(``repro_torch.launch.trace_analysis.read_profile``'s arithmetic, copied
into ``stats.union_length``).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import stats

Span = Tuple[str, float, float]  # name, start, end (seconds on the profiler's clock)


@dataclass
class Trace:
    kernels: List[Span] = field(default_factory=list)  # device operations
    host: List[Span] = field(default_factory=list)  # host ops, the harness's ranges left out
    ranges: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    range_device_s: Dict[str, float] = field(default_factory=dict)  # device time under each

    def busy_s(self, lo: float, hi: float) -> float:
        return stats.union_length(stats.clipped([(a, b) for _, a, b in self.kernels], lo, hi))

    def kernel_calls(self, symbol: str, lo: float, hi: float) -> List[float]:
        """The device seconds of each call of a kernel whose name holds
        ``symbol`` as a whole identifier, started inside [lo, hi]."""
        pat = re.compile(rf"(?<![\w]){re.escape(symbol)}(?![\w])")
        return [b - a for name, a, b in self.kernels if lo <= a <= hi and pat.search(name)]

    def top_ops(self, lo: float, hi: float, n: int = 10) -> List[List]:
        """The ``n`` device operations that took the most time in [lo, hi]."""
        total: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels:
            if b > lo and a < hi:
                total[name] += min(b, hi) - max(a, lo)
        return [[name, s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, lo: float, hi: float, n: int = 10, longest: int = 256) -> List[List]:
        """The device's idle time in [lo, hi] by what the host was doing at
        each gap's middle (its innermost op): the ``longest`` gaps, summed
        by that op, the ``n`` largest sums."""
        import numpy as np

        spans = sorted(stats.gaps([(x, y) for _, x, y in self.kernels], lo, hi),
                       key=lambda g: g[0] - g[1])[:longest]
        names = [name for name, _, _ in self.host]
        starts = np.array([x for _, x, _ in self.host])
        ends = np.array([y for _, _, y in self.host])
        total: Dict[str, float] = defaultdict(float)
        for a, b in spans:
            mid = (a + b) / 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            label = (names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size
                     else "(no host op)")
            total[label] += b - a
        return [[name, s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def device_time_s(event) -> float:
    us = getattr(event, "device_time_total", None)
    if us is None:
        us = getattr(event, "cuda_time_total", 0.0)
    return us / 1e6


def read(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    t = Trace()
    device_s: Dict[str, float] = defaultdict(float)
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("perfbench.") and e.device_type == DeviceType.CUDA:
            continue  # the range's mirror on the device's timeline: no operation
        if e.device_type == DeviceType.CUDA:
            t.kernels.append((e.name, start, end))
        elif e.name.startswith("perfbench."):
            t.ranges.setdefault(e.name, []).append((start, end))
            device_s[e.name] += device_time_s(e)
        else:
            t.host.append((e.name, start, end))
    for spans in t.ranges.values():
        spans.sort()
    t.range_device_s = dict(device_s)
    return t


def first(trace: Trace, name: str) -> Optional[Tuple[float, float]]:
    spans = trace.ranges.get(name)
    return spans[0] if spans else None
