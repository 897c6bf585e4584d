"""What a step costs, from the step itself: the port's ``hlo_analysis``.

The reference compiles each step with XLA and parses the optimized HLO
text for its FLOPs, HBM traffic and collectives, weighting loop bodies by
their trip counts.  The port runs eagerly: there is no compiled program
and no HLO to parse, and every aten op is a kernel of its own.  So the two
questions are asked of the ops directly.

``count(fn, *args)`` runs the step (on ``meta`` tensors: shapes only,
nothing allocated) under two dispatch modes and returns

  * its FLOPs, from ``torch.utils.flop_counter.FlopCounterMode`` (the
    counterpart of ``analyze(...).flops``);
  * its HBM bytes: the input and output bytes of every aten op that moves
    data.  No op fuses in the eager port, so that sum is its traffic;
    views and allocations move nothing and are left out, and an op that
    reads or writes through indices counts the elements it touches;
  * the ops by name with their calls and bytes (the counterpart of
    ``top_buffers``).

``read_profile(prof)`` reads a ``torch.profiler`` run of a step on the
card: the device kernels by name with their launches and device time, and
the busy and idle share of the window; ``check_launches`` holds named
kernels to an exact number of launches.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# Ops that move no data: a fresh buffer is not written; a detach, alias or
# unsafe view is a view by another name.
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
               aten._unsafe_view, aten._reshape_alias}
# Reads through indices touch only the gathered elements of their first
# argument: they read the indices and as many elements as they write.
_INDEXED_READS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# In-place writes through indices touch only the indexed elements of their
# first argument: they read the indices and values and write as many.
_INDEXED_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
                   aten.index_add_, aten.scatter_, aten.scatter_add_, aten.scatter_reduce_}


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclass
class OpStat:
    calls: int = 0
    bytes: int = 0


@dataclass
class StepCount:
    flops: int
    bytes: int
    ops: Dict[str, OpStat] = field(default_factory=dict)

    def top_ops(self, n: int = 15) -> List[Tuple[str, int, int]]:
        """The ``n`` ops that move the most bytes: (name, calls, bytes)."""
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1].bytes)[:n]
        return [(name, s.calls, s.bytes) for name, s in rows]


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops: Dict[str, OpStat] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if not func.is_view and packet not in _NO_TRAFFIC:
            if packet in _INDEXED_READS:
                n = _nbytes((args[1:], kwargs)) + 2 * _nbytes(out)
            elif packet in _INDEXED_WRITES:
                n = 2 * _nbytes((args[1:], kwargs))
            else:
                n = _nbytes((args, kwargs)) + _nbytes(out)
            self.total += n
            stat = self.ops.setdefault(str(packet), OpStat())
            stat.calls += 1
            stat.bytes += n
        return out


def count(fn, *args, **kwargs) -> StepCount:
    """FLOPs, bytes and ops of ``fn(*args, **kwargs)``, backward included
    where ``fn`` runs one."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        fn(*args, **kwargs)
    return StepCount(flops=flops.get_total_flops(), bytes=nbytes.total, ops=nbytes.ops)


# --------------------------------------------------------------------------
# Profiles of the card
# --------------------------------------------------------------------------
@dataclass
class KernelStat:
    launches: int = 0
    device_ms: float = 0.0


@dataclass
class ProfileReading:
    kernels: Dict[str, KernelStat]
    busy_ms: float
    window_ms: float

    @property
    def busy_share(self) -> float:
        return self.busy_ms / self.window_ms if self.window_ms > 0 else 0.0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_share

    def launches_of(self, symbol: str) -> int:
        """Launches of the kernels whose name holds ``symbol`` as a whole
        identifier (a template's instances and their signatures included)."""
        pat = re.compile(rf"(?<![\w]){re.escape(symbol)}(?![\w])")
        return sum(k.launches for name, k in self.kernels.items() if pat.search(name))

    def top(self, n: int = 8) -> List[Tuple[str, KernelStat]]:
        return sorted(self.kernels.items(), key=lambda kv: -kv[1].device_ms)[:n]


def read_profile(prof, wall_ms: Optional[float] = None) -> ProfileReading:
    """The device's kernels, launches and busy share in a profiled window.

    ``prof`` is a finished ``torch.profiler.profile`` (anything whose
    ``events()`` gives events with ``name``, ``device_type`` and
    ``time_range`` in microseconds).  Busy time is the union of the device
    events' intervals; the window is ``wall_ms`` where the caller timed it,
    else the span of all events."""
    kernels: Dict[str, KernelStat] = {}
    spans: List[Tuple[float, float]] = []
    first, last = float("inf"), float("-inf")
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        first, last = min(first, start), max(last, end)
        if e.device_type != DeviceType.CUDA:
            continue
        stat = kernels.setdefault(e.name, KernelStat())
        stat.launches += 1
        stat.device_ms += (end - start) / 1e3
        spans.append((start, end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    if wall_ms is None:
        wall_ms = (last - first) / 1e3 if last > first else 0.0
    return ProfileReading(kernels=kernels, busy_ms=busy_us / 1e3, window_ms=wall_ms)


def check_launches(reading: ProfileReading, expected: Mapping[str, int]) -> Dict[str, int]:
    """The device-side launches of each named kernel; raises unless each
    equals its expected count."""
    got = {symbol: reading.launches_of(symbol) for symbol in expected}
    if got != dict(expected):
        raise AssertionError(f"device-side launches {got}, expected {dict(expected)}")
    return got
