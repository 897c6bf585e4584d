"""Nemesis: declarative fault injection at the ``runtime.Transport`` boundary.

The paper's safety claims (Sections 3, 5, 6) are stated over the
asynchronous network model — arbitrary drops, duplication, reordering and
crash-stop failures — but a test suite only earns those claims by
*driving* the adversary, not merely tolerating it.  This module is the
adversary:

  * **Faults** are small frozen dataclasses (``Crash``, ``Restart``,
    ``Partition``, ``Storm``, ``Heal``) plus protocol *actions*
    (``ReconfigureRandom``, ``MMReconfigure``, ``Takeover``, …) so a whole
    adversarial run is a printable, replayable value.
  * A **Schedule** is a seeded, deterministic list of timed events.  Any
    failure anywhere in the scenario harness reports the one-line
    ``(seed, schedule)`` tuple that reproduces the identical run.
  * The **FaultPlane** is the interposition point both transports consult
    on every send (``Simulator.faults`` / ``AsyncTransport.faults``):
    asymmetric/symmetric partitions and drop/dup/delay storms installed
    and healed mid-run, identically on the deterministic simulator and
    the asyncio runtime.
  * The **Nemesis** binds a schedule to a live deployment: it arms every
    event on the transport clock, applies it, appends a deterministic
    line to its event log, and runs the invariant checker after each
    event.

Crash semantics follow the classic distinction (Jepsen's nemesis menu):
a *clean* crash (SIGTERM) flushes buffered hot-path batches onto the wire
before dying; *kill -9* drops them.  ``Restart`` models recovery from
synchronously persisted state — acceptor promises/votes, matchmaker logs
and replica logs survive; a proposer's leadership and in-flight round
state are process-memory and are wiped (``reset_volatile``).

The invariant checker (``check_invariants``) asserts, at any instant:

  1. at most one value is chosen per slot, across all rounds and all
     acceptor configurations (the oracle's record, cross-checked against
     every replica log and every proposer's chosen log);
  2. replica logs are prefix-consistent and executed prefixes agree;
  3. client-observed results are linearizable against the chosen log
     (replaying the chosen prefix through a fresh state machine must
     reproduce every result any client observed);
  4. GC never outruns durability: every slot below any acceptor's
     Scenario-3 watermark is stored on at least f+1 replicas.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from . import messages as m

Address = str


# --------------------------------------------------------------------------
# Fault and action vocabulary
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Crash:
    """Crash ``addr``.  ``clean=True`` = SIGTERM (flush buffered batches
    first); ``clean=False`` = kill -9 (in-flight effects are lost)."""

    addr: Address
    clean: bool = False


@dataclass(frozen=True)
class Restart:
    """Restart ``addr`` from persisted state.  ``wipe_volatile`` drops
    process-memory state (a proposer's leadership, in-flight contexts)."""

    addr: Address
    wipe_volatile: bool = True


@dataclass(frozen=True)
class Partition:
    """Cut ``side_a`` off from ``side_b``.  ``symmetric=False`` drops only
    a->b traffic (the asymmetric half-open partition)."""

    side_a: Tuple[Address, ...]
    side_b: Tuple[Address, ...]
    symmetric: bool = True


@dataclass(frozen=True)
class Storm:
    """A message storm: per-message drop/dup probability and extra
    exponential delay, scoped to ``targets`` (either endpoint matches;
    ``None`` = the whole cluster)."""

    drop: float = 0.0
    dup: float = 0.0
    delay: float = 0.0  # mean extra delay per message (exponential)
    targets: Optional[Tuple[Address, ...]] = None
    tag: str = "storm"


@dataclass(frozen=True)
class ClockSkew:
    """Skew ``addr``'s local clock: every timer delay the node arms is
    scaled by ``scale`` and shifted by ``offset`` seconds (floored at 0).
    ``scale > 1`` models a slow clock (timers fire late: heartbeats,
    retransmissions and election checks all drift), ``scale < 1`` a fast
    one.  The protocol must stay safe under arbitrary skew — the paper's
    asynchronous model has no clock synchronization at all (Section 2.1).
    Removed by ``Heal`` or by installing ``ClockSkew(addr, 1.0, 0.0)``."""

    addr: Address
    scale: float = 1.0
    offset: float = 0.0


@dataclass(frozen=True)
class DiskLoss:
    """Replica ``addr`` loses its persisted log (disk wipe).

    The paper's crash-recovery model assumes synchronously persisted
    state survives a restart; this fault breaks that assumption for one
    replica: its log, state machine and at-most-once dedup table are
    wiped, and on its next (re)start it re-syncs the chosen prefix from
    its peer replicas (``RecoverA``/``RecoverB``) before serving again.
    Safety must hold throughout — in particular the GC durability bar
    (Scenario 3's f+1-replica rule) is what makes a single disk loss
    survivable at all.  Typically scheduled between a ``Crash`` and its
    ``Restart``; applied to a live replica it wipes and re-syncs in
    place."""

    addr: Address


@dataclass(frozen=True)
class Pause:
    """Wedge ``addr`` without killing it — the gray failure: the process
    is alive and its connections stay up, but it executes nothing.

    The proc plane delivers this as a real ``SIGSTOP``; the in-process
    transports model it as delivery-deferral (inbound messages and the
    node's own timers queue, in order, until :class:`Resume`).  Unlike a
    crash, nothing is lost: on resume the whole backlog floods in at
    once, which is exactly the stale-round burst the protocol must nack
    its way through.  Unlike a partition, the node's peers see an open,
    accepting connection the entire time — the failure detector's
    confirm-over-consecutive-rounds logic is what distinguishes wedged
    from slow."""

    addr: Address


@dataclass(frozen=True)
class Resume:
    """Un-wedge a :class:`Pause`d node (SIGCONT); its deferred inbound
    messages and timers run in their original order."""

    addr: Address


@dataclass(frozen=True)
class Heal:
    """Remove every partition, storm and clock skew currently installed."""


@dataclass(frozen=True)
class ReconfigureRandom:
    """Leader swaps to a random 2f+1 acceptor subset (Section 8.1).
    ``shard`` scopes the swap to one proposer shard's acceptor group."""

    shard: int = 0


@dataclass(frozen=True)
class MMReconfigure:
    """Section 6 matchmaker reconfiguration onto ``new_set``."""

    new_set: Tuple[Address, ...]


@dataclass(frozen=True)
class Takeover:
    """Proposer ``index`` (of shard ``shard``) runs leader takeover with a
    fresh random configuration (full Phase 1, no bypass)."""

    index: int
    shard: int = 0


@dataclass(frozen=True)
class StartClients:
    pass


@dataclass(frozen=True)
class StopClients:
    pass


Fault = Any  # union of the dataclasses above


@dataclass(frozen=True)
class Event:
    at: float
    fault: Fault


@dataclass(frozen=True)
class Schedule:
    """A named, seeded, deterministic adversarial schedule.

    ``repr(schedule)`` is the one-line replay token: scenario failures
    print it, and re-running the scenario with the same ``(name, seed)``
    regenerates a value-equal schedule and a byte-identical event log.
    """

    name: str
    seed: int
    events: Tuple[Event, ...]

    def __repr__(self) -> str:
        evs = ", ".join(f"({e.at:.6f}, {e.fault!r})" for e in self.events)
        return f"Schedule(name={self.name!r}, seed={self.seed}, events=[{evs}])"


# --------------------------------------------------------------------------
# FaultPlane: the transport interposition point
# --------------------------------------------------------------------------
class FaultPlane:
    """Consulted by both transports on every send.

    ``on_send`` returns ``None`` to drop the message, or a list of extra
    delivery delays — ``[0.0]`` for normal delivery, ``[0.0, d]`` for a
    duplicate arriving ``d`` later.  All randomness comes from the
    transport's seeded RNG, so faulty runs replay exactly.
    """

    def __init__(self) -> None:
        self._partitions: List[Tuple[FrozenSet[Address], FrozenSet[Address], bool]] = []
        self._storms: List[Storm] = []
        self._skews: Dict[Address, Tuple[float, float]] = {}  # addr -> (scale, offset)
        # telemetry
        self.dropped_by_partition = 0
        self.dropped_by_storm = 0
        self.duplicated = 0
        self.skewed_timers = 0

    # -- installation ------------------------------------------------------
    def partition(
        self,
        side_a: Sequence[Address],
        side_b: Sequence[Address],
        *,
        symmetric: bool = True,
    ) -> None:
        self._partitions.append((frozenset(side_a), frozenset(side_b), symmetric))

    def add_storm(self, storm: Storm) -> None:
        self._storms.append(storm)

    def end_storm(self, tag: str) -> None:
        self._storms = [s for s in self._storms if s.tag != tag]

    def set_skew(self, addr: Address, scale: float = 1.0, offset: float = 0.0) -> None:
        """Install (or clear, with scale=1/offset=0) a clock skew."""
        if scale == 1.0 and offset == 0.0:
            self._skews.pop(addr, None)
        else:
            self._skews[addr] = (scale, offset)

    def heal(self) -> None:
        self._partitions.clear()
        self._storms.clear()
        self._skews.clear()

    @property
    def active(self) -> bool:
        return bool(self._partitions or self._storms or self._skews)

    # -- the interposition -------------------------------------------------
    def on_send(
        self,
        src: Address,
        dst: Address,
        msg: Any,
        now: float,
        rng: random.Random,
    ) -> Optional[List[float]]:
        for a, b, symmetric in self._partitions:
            if (src in a and dst in b) or (symmetric and src in b and dst in a):
                self.dropped_by_partition += 1
                return None
        extras = [0.0]
        for s in self._storms:
            if s.targets is not None and src not in s.targets and dst not in s.targets:
                continue
            if s.drop and rng.random() < s.drop:
                self.dropped_by_storm += 1
                return None
            base = 0.0
            if s.delay:
                base = rng.expovariate(1.0 / s.delay)
                extras = [e + base for e in extras]
            if s.dup and rng.random() < s.dup:
                self.duplicated += 1
                extras = extras + [extras[0] + rng.expovariate(1.0 / max(s.delay, 1e-4))]
        return extras

    def on_timer(self, addr: Address, delay: float) -> float:
        """Clock-skew interposition: both transports route every timer a
        node arms through here.  Deterministic (no RNG), so skewed runs
        replay exactly.  Skewed delays are floored at a positive epsilon:
        a zero delay would let a self-rearming timer (heartbeats, probe
        ticks) respawn at the same instant forever — a livelock, not a
        fast clock."""
        skew = self._skews.get(addr)
        if skew is None:
            return delay
        scale, offset = skew
        self.skewed_timers += 1
        return max(1e-6, delay * scale + offset)


# --------------------------------------------------------------------------
# Invariant checker
# --------------------------------------------------------------------------
def _value_eq(a: Any, b: Any) -> bool:
    if isinstance(a, m.Noop) and isinstance(b, m.Noop):
        return True
    return a == b


def check_invariants(dep: Any) -> List[str]:
    """Check consensus safety on a live deployment; returns violations.

    Safe to run at *any* instant — every invariant below is stable under
    in-flight messages (a chosen value never un-chooses; replica logs and
    watermarks only grow).
    """
    violations: List[str] = []
    oracle = dep.oracle
    chosen = oracle.chosen

    # 1a. The oracle itself observed a double-choose.
    violations.extend(oracle.violations)

    # 1b. Every replica log entry must match the oracle's chosen record.
    for r in dep.replicas:
        for slot, val in r.log.items():
            rec = chosen.get(slot)
            if rec is not None and not _value_eq(rec.value, val):
                violations.append(
                    f"replica {r.addr} slot {slot}: logged {val!r} but oracle "
                    f"chose {rec.value!r}"
                )

    # 1c. Every proposer's learned log must match the oracle too.
    for p in dep.proposers:
        for slot, val in p.chosen_values.items():
            rec = chosen.get(slot)
            if rec is not None and not _value_eq(rec.value, val):
                violations.append(
                    f"proposer {p.addr} slot {slot}: learned {val!r} but "
                    f"oracle chose {rec.value!r}"
                )

    # 2. Replica logs are pairwise consistent on shared slots, and every
    #    executed prefix is fully present (no holes below the watermark).
    logs = [(r.addr, r.log, r.exec_watermark) for r in dep.replicas]
    for i, (addr_a, log_a, wm_a) in enumerate(logs):
        for s in range(wm_a):
            if s not in log_a:
                violations.append(
                    f"replica {addr_a}: hole at slot {s} below exec "
                    f"watermark {wm_a}"
                )
        for addr_b, log_b, _ in logs[i + 1 :]:
            for slot in log_a.keys() & log_b.keys():
                if not _value_eq(log_a[slot], log_b[slot]):
                    violations.append(
                        f"replicas {addr_a}/{addr_b} diverge at slot {slot}: "
                        f"{log_a[slot]!r} vs {log_b[slot]!r}"
                    )

    # 3. Linearizability of client-observed results: replay the chosen
    #    contiguous prefix through a fresh state machine; every reply any
    #    client saw must match the replayed result for its command, and a
    #    reply for a command absent from the prefix is a phantom.
    sm_factory = getattr(dep, "sm_factory", None)
    if sm_factory is not None:
        sm = sm_factory()
        replayed: Dict[Any, Any] = {}
        slot = 0
        while slot in chosen:
            val = chosen[slot].value
            if isinstance(val, m.Command) and val.cmd_id not in replayed:
                replayed[val.cmd_id] = sm.apply(val.op)
            slot += 1
        for c in dep.clients:
            for cmd_id, replies in c.replies_by_cmd.items():
                if cmd_id not in replayed:
                    # The command may be chosen beyond the contiguous
                    # prefix only if some replica executed it — which
                    # requires *its* contiguous prefix to include it, so
                    # absence here means a phantom result.
                    violations.append(
                        f"client {c.addr}: observed a result for {cmd_id} "
                        f"which is not in the chosen prefix (len {slot})"
                    )
                    continue
                expect = replayed[cmd_id]
                for rep in replies:
                    if not _value_eq(rep.result, expect):
                        violations.append(
                            f"client {c.addr} cmd {cmd_id}: observed "
                            f"{rep.result!r}, chosen-log replay gives "
                            f"{expect!r}"
                        )

    # 4. GC / durability: any slot below an acceptor's Scenario-3 chosen
    #    watermark must be stored on >= f+1 replicas — otherwise a future
    #    leader could be told to skip re-proposing a slot that is nowhere.
    need = min(dep.f + 1, len(dep.replicas))
    for a in dep.acceptors:
        w = a.chosen_watermark
        if w <= 0:
            continue
        holders = sum(
            1 for r in dep.replicas if all(s in r.log for s in range(w))
        )
        if holders < need:
            violations.append(
                f"acceptor {a.addr}: chosen_watermark {w} but only "
                f"{holders} replicas hold the full prefix (need {need})"
            )

    return violations


# --------------------------------------------------------------------------
# The nemesis driver
# --------------------------------------------------------------------------
class Nemesis:
    """Arms a :class:`Schedule` against a live deployment.

    Every event is applied on the transport clock; after each one the
    invariant checker runs and its findings are accumulated (with the
    offending event attached).  The ``event_log`` is a list of formatted
    lines that is byte-for-byte reproducible for a given (seed, schedule)
    on the deterministic simulator.
    """

    def __init__(
        self,
        dep: Any,
        schedule: Schedule,
        *,
        check: Optional[Callable[[Any], List[str]]] = check_invariants,
        on_event: Optional[Callable[[Event], None]] = None,
        plane: Optional[FaultPlane] = None,
    ):
        self.dep = dep
        self.transport = dep.sim
        self.schedule = schedule
        self.check = check
        self.on_event = on_event
        # ``plane`` lets a deployment substitute a FaultPlane subclass —
        # the proc plane fans partition/storm/skew installs out to every
        # worker process's own plane.
        self.plane = plane if plane is not None else FaultPlane()
        self.transport.faults = self.plane
        self.event_log: List[str] = []
        self.violations: List[str] = []
        self.applied = 0

    # ------------------------------------------------------------------
    def arm(self) -> "Nemesis":
        for ev in self.schedule.events:
            self.transport.call_at(ev.at, lambda ev=ev: self._apply(ev))
        return self

    # ------------------------------------------------------------------
    def _apply(self, ev: Event) -> None:
        f = ev.fault
        if isinstance(f, Crash):
            self.transport.crash(f.addr, clean=f.clean)
        elif isinstance(f, Restart):
            self.transport.restart(f.addr, wipe_volatile=f.wipe_volatile)
        elif isinstance(f, Partition):
            self.plane.partition(f.side_a, f.side_b, symmetric=f.symmetric)
        elif isinstance(f, Storm):
            self.plane.add_storm(f)
        elif isinstance(f, ClockSkew):
            self.plane.set_skew(f.addr, f.scale, f.offset)
        elif isinstance(f, Pause):
            self.transport.pause(f.addr)
        elif isinstance(f, Resume):
            self.transport.resume(f.addr)
        elif isinstance(f, DiskLoss):
            self.transport.nodes[f.addr].lose_disk()
        elif isinstance(f, Heal):
            self.plane.heal()
        elif isinstance(f, ReconfigureRandom):
            self.dep.reconfigure_random(f.shard)
        elif isinstance(f, MMReconfigure):
            self.dep.reconfigure_matchmakers(f.new_set)
        elif isinstance(f, Takeover):
            p = self.dep.shard_proposers(f.shard)[f.index]
            if not p.failed:
                p.become_leader(self.dep.random_config(f.shard))
        elif isinstance(f, StartClients):
            self.dep.start_clients()
        elif isinstance(f, StopClients):
            self.dep.stop_clients()
        else:  # pragma: no cover - schedule construction bug
            raise TypeError(f"unknown nemesis fault {f!r}")
        self.applied += 1
        self.event_log.append(f"t={ev.at:.6f} {f!r}")
        if self.check is not None:
            for v in self.check(self.dep):
                entry = f"after {f!r} @ {ev.at:.6f}: {v}"
                if entry not in self.violations:
                    self.violations.append(entry)
        if self.on_event is not None:
            self.on_event(ev)

    # ------------------------------------------------------------------
    def final_check(self) -> List[str]:
        """Run the checker once more at quiescence; returns ALL findings."""
        if self.check is not None:
            for v in self.check(self.dep):
                entry = f"final: {v}"
                if entry not in self.violations:
                    self.violations.append(entry)
        return self.violations

    def replay_line(self) -> str:
        """The one-line reproduction token printed on any failure."""
        return f"(seed={self.schedule.seed}, schedule={self.schedule!r})"
