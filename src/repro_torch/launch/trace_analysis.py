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
    ``top_buffers``);
  * its collectives: one record for each kind of functional collective
    issued (op, result bytes, the global ranks of its group, and how many
    times), the input ``roofline.collective_traffic`` takes.

On a mesh (the step on DTensors) every count is of one rank's LOCAL ops:
an op on DTensors is passed on by the modes (``NotImplemented``), so
DTensor's own dispatch runs the local ops, the collectives of its
redistributions among them, and the modes count those.  So the FLOPs and
bytes are per device, as the reference's ``flops_per_device`` is.  On a
CPU mesh (the fake process group of the dry-run, or gloo) DTensor moves a
tensor from one split to another by an all-gather of the whole and a
chunk, which it records as such; on a CUDA mesh (NCCL, and the dry-run's
production meshes) it runs an all-to-all.

``read_profile(prof)`` reads a ``torch.profiler`` run of a step on the
card: the device kernels by name with their launches and device time, and
the busy and idle share of the window; ``check_launches`` holds named
kernels to their expected launches, exactly or, where the caller names a
kernel, within a stated shortfall.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.autograd import DeviceType
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

aten = torch.ops.aten

# Ops that move no data: a fresh buffer is not written; a detach, alias or
# unsafe view is a view by another name; a collective's wait and wrap hand
# on its result.
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
               aten._unsafe_view, aten._reshape_alias,
               torch.ops._c10d_functional.wait_tensor,
               torch.ops._c10d_functional._wrap_tensor_autograd}
# Reads through indices touch only the gathered elements of their first
# argument: they read the indices and as many elements as they write.
_INDEXED_READS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# In-place writes through indices touch only the indexed elements of their
# first argument: they read the indices and values and write as many.
_INDEXED_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
                   aten.index_add_, aten.scatter_, aten.scatter_add_, aten.scatter_reduce_}


# The functional collectives (``torch.ops._c10d_functional``, and
# ``torch.ops._dtensor``'s all-to-all) by the names
# ``roofline.collective_traffic`` reads, and the position of the group (its
# name) among each op's arguments.
_COLLECTIVES = {"all_gather_into_tensor": ("all-gather", 2),
                "reduce_scatter_tensor": ("reduce-scatter", 3),
                "all_reduce": ("all-reduce", 2),
                "all_to_all_single": ("all-to-all", 3),
                "broadcast": ("collective-permute", 2),
                # DTensor's move from one split to another on a CUDA mesh
                "shard_dim_alltoall": ("all-to-all", 3)}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")


def _tensors(args, kwargs) -> Iterator[torch.Tensor]:
    """The tensors among an op's arguments (an aten op's are at the top
    level or in a list there)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _on_dtensors(args, kwargs) -> bool:
    return any(isinstance(t, DTensor) for t in _tensors(args, kwargs))


def _on_fakes(args, kwargs) -> bool:
    """Whether the op runs on fake tensors: DTensor's sharding propagation
    runs an op once so on a cache miss, to learn its output's shape; that
    run is no part of the step."""
    return any(isinstance(t, FakeTensor) for t in _tensors(args, kwargs))


def _group_ranks(group) -> Tuple[int, ...]:
    """The global ranks of a process group, given by its name or itself."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):
        group = _resolve_process_group(group)
    return tuple(dist.get_process_group_ranks(group))


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
    collectives: List[Dict[str, Any]] = field(default_factory=list)

    def top_ops(self, n: int = 15) -> List[Tuple[str, int, int]]:
        """The ``n`` ops that move the most bytes: (name, calls, bytes)."""
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1].bytes)[:n]
        return [(name, s.calls, s.bytes) for name, s in rows]


class _ByteCounter(TorchDispatchMode):
    """The bytes of each local op, and the collectives issued."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.ops: Dict[str, OpStat] = {}
        self.collectives: Dict[Tuple[str, int, Tuple[int, ...]], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _on_dtensors(args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        if _on_fakes(args, kwargs):
            return out
        packet = func.overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES and packet.__name__ in _COLLECTIVES:
            op, at = _COLLECTIVES[packet.__name__]
            key = (op, _nbytes(out), _group_ranks(args[at]))
            self.collectives[key] = self.collectives.get(key, 0) + 1
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


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(args, kwargs or {}):
            return NotImplemented
        if _on_fakes(args, kwargs or {}):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class _LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` of the local ops: an op on DTensors is counted
    as the local ops that DTensor runs for it."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


def count(fn, *args, **kwargs) -> StepCount:
    """FLOPs, bytes, ops and collectives of ``fn(*args, **kwargs)``,
    backward included where ``fn`` runs one; on DTensors, one rank's."""
    flops = _LocalFlopCounter(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        fn(*args, **kwargs)
    collectives = [dict(op=op, result_bytes=b, group_size=len(ranks), count=n,
                        explicit_groups=[list(ranks)])
                   for (op, b, ranks), n in nbytes.collectives.items()]
    return StepCount(flops=flops.get_total_flops(), bytes=nbytes.total, ops=nbytes.ops,
                     collectives=collectives)


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


def check_launches(reading: ProfileReading, expected: Mapping[str, int],
                   missing_ok: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """The device-side launches of each named kernel; raises unless each
    equals its expected count, or, for a kernel named in ``missing_ok``,
    falls short of it by at most that many and is not 0 where any was
    expected."""
    missing_ok = dict(missing_ok or {})
    got = {symbol: reading.launches_of(symbol) for symbol in expected}

    def held(symbol: str, n: int) -> bool:
        return n - missing_ok.get(symbol, 0) <= got[symbol] <= n and (got[symbol] > 0 or n == 0)

    if not all(held(symbol, n) for symbol, n in expected.items()):
        raise AssertionError(f"device-side launches {got}, expected {dict(expected)}"
                             + (f" (at most {missing_ok} fewer)" if missing_ok else ""))
    return got
