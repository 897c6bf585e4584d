"""Verification plane: bounded model checking over the deterministic simulator.

Randomized nemesis seeds *sample* the schedule space; this module
*enumerates* it.  The explorer drives small model families — 2–5 node
clusters of the real role classes, not abstractions of them — through
every enabled-event interleaving the paper's asynchronous network model
(Section 2.1) allows, up to configurable depth/state bounds, checking the
scenarios-suite invariants at every step and every terminal.

Design
------
* **Frontier.**  ``Simulator.pending_events()`` exposes every live heap
  record by its stable insertion seq; ``run_event(seq)`` runs one of them
  out of heap order.  Messages may be arbitrarily delayed and reordered,
  so *any* pending delivery is a legal next step; pending timers are
  freely ordered too, which over-approximates real executions by allowing
  unbounded clock drift — sound for the safety invariants checked here
  (the protocol must tolerate arbitrary skew; see ``nemesis.ClockSkew``).
  Deliveries to a crashed or paused node stay pending (arbitrary network
  delay); the lost-message case is the explicit ``drop`` fault choice.
* **Fork-by-replay.**  Simulator state is closures-in-a-heap and cannot
  be snapshotted; instead a state *is* its choice prefix.  The DFS runs
  the first child in place and rebuilds from scratch (family build +
  prefix replay) for each sibling.  All sources of nondeterminism are
  pinned: the MC network draws no RNG (zero jitter/drop/dup), families
  use deterministic config providers, and seq allocation is a counter —
  so a prefix always rebuilds the identical state.
* **DPOR.**  Sleep-set partial-order reduction: two choices commute iff
  they touch disjoint nodes (a delivery to X and a delivery to Y lead to
  the same state in either order); fault choices additionally contend for
  the shared fault budget and are mutually dependent.  After exploring
  choice ``c`` from a state, ``c`` sleeps in the siblings' subtrees until
  a dependent choice runs.
* **Fingerprints.**  A state hashes as the canonical encoding
  (``wire.encode_canonical``) of every node's ``mc_state()`` + failed/
  paused flags, the multiset of in-flight messages (by wire encoding) and
  pending timers, the oracle's chosen record, and the remaining fault/
  timer budgets.  Delivery times and seq ids are excluded — two
  interleavings that reach the same logical state hash identically and
  the second is pruned.  Pruning accounts for sleep sets and depth: a
  revisit is skipped only if the stored visit explored at least as much
  (smaller-or-equal sleep set) with at least as much depth budget.
* **Counterexamples.**  A violating trace is emitted as a one-line
  replayable ``nemesis.Schedule`` whose events are ``Fire``/``DropEvent``/
  ``DupEvent`` (simulator-event choices, by stable seq) and the nemesis
  vocabulary's ``Crash``/``Restart``/``Pause``/``Resume``; timestamps are
  ordinals.  ``replay()`` rebuilds the family and applies the events in
  order; the schedule is auto-minimized through the existing ddmin
  machinery (``scenarios.shrink_schedule`` / ``shrink_timing``).

Model families
--------------
``single_decree``           3 nodes: two proposers racing different values
                            through one combined matchmaker+acceptor box
                            (f = 0).  Small enough to exhaust, rich enough
                            to exercise matchmaking, Phase 1 + pruning,
                            and Phase 2.
``single_decree_mutated``   Same, but the proposers apply Optimization
                            4's pruning rule with an unconditional floor
                            (they never observe prior votes) — the
                            mutation self-test: the explorer must find the
                            double-choose this causes.
``mm_reconfig``             5 nodes: one proposer racing a matchmaker
                            reconfiguration (Section 6) that moves the
                            set from the old combined box to a fresh
                            matchmaker, coordinator retries included.
                            Bounded (not exhaustive) exploration.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from . import messages as m
from . import wire
from .acceptor import Acceptor
from .matchmaker import Matchmaker
from .mm_reconfig import MMReconfigCoordinator
from .nemesis import (
    Crash,
    Event,
    Pause,
    Restart,
    Resume,
    Schedule,
    check_invariants,
)
from .oracle import Oracle, SafetyViolation
from .quorums import Configuration
from .rounds import NEG_INF, Round
from .runtime import on
from .scenarios import shrink_schedule, shrink_timing
from .sim import Address, NetworkConfig, Node, Simulator, event_kind, event_target
from .single import SingleDecreeProposer


def mc_network() -> NetworkConfig:
    """The MC network: zero jitter/drop/dup/overhead, so ``plan_delivery``
    draws no randomness.  Identical logical states then have identical
    futures — the soundness condition for fingerprint pruning and DPOR."""
    return NetworkConfig(base_latency=0.0, jitter=0.0)


# --------------------------------------------------------------------------
# Counterexample vocabulary (extends nemesis's fault dataclasses)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Fire:
    """Run pending simulator event ``seq`` (a delivery or a timer).

    Seq ids are allocated deterministically, so within a rebuilt model
    family the same choice prefix always names the same event.  ``note``
    is a human-readable description and does not affect equality."""

    seq: int
    note: str = field(default="", compare=False)


@dataclass(frozen=True)
class DropEvent:
    """Drop pending delivery ``seq``: the network lost this message."""

    seq: int
    note: str = field(default="", compare=False)


@dataclass(frozen=True)
class DupEvent:
    """Duplicate pending delivery ``seq``: the network copied it."""

    seq: int
    note: str = field(default="", compare=False)


# --------------------------------------------------------------------------
# Model systems and families
# --------------------------------------------------------------------------
class ModelSystem:
    """One live instance of a model family: a tiny cluster wired to a
    zero-randomness simulator, plus the invariant suite over it."""

    def __init__(
        self,
        sim: Simulator,
        oracle: Oracle,
        *,
        proposers: Tuple[Any, ...] = (),
        fault_targets: Tuple[Address, ...] = (),
        f: int = 0,
        extra_check: Optional[Callable[["ModelSystem"], List[str]]] = None,
    ):
        self.sim = sim
        self.oracle = oracle
        self.proposers = tuple(proposers)
        self.fault_targets = tuple(fault_targets)
        self.f = f
        self.extra_check = extra_check

    @property
    def acceptors(self) -> Tuple[Any, ...]:
        return tuple(
            n for n in self.sim.nodes.values() if isinstance(n, Acceptor)
        )

    @property
    def matchmakers(self) -> Tuple[Any, ...]:
        return tuple(
            n for n in self.sim.nodes.values() if isinstance(n, Matchmaker)
        )

    def check(self) -> List[str]:
        """The full scenarios-suite invariant check, plus family extras.

        ``nemesis.check_invariants`` runs unchanged over a deployment-
        shaped view; model families carry no replicas or clients, so its
        replica/linearizability/GC clauses hold vacuously and the oracle
        + proposer cross-checks do the work.  The matchmaker-handover
        completeness check covers the reconfiguration families."""
        violations = list(check_invariants(_DepView(self)))
        violations.extend(_mm_handover_check(self))
        if self.extra_check is not None:
            violations.extend(self.extra_check(self))
        return violations


class _PView:
    """check_invariants expects proposers with .addr/.chosen_values."""

    __slots__ = ("addr", "chosen_values")

    def __init__(self, addr: Address, chosen_values: Dict[int, Any]):
        self.addr = addr
        self.chosen_values = chosen_values


class _DepView:
    """Deployment-shaped adapter so the scenarios suite's checker
    (``nemesis.check_invariants``) runs unchanged over a model family."""

    def __init__(self, sys: ModelSystem):
        self.oracle = sys.oracle
        self.f = sys.f
        self.replicas: Tuple[Any, ...] = ()
        self.clients: Tuple[Any, ...] = ()
        self.sm_factory = None
        self.acceptors = sys.acceptors
        self.proposers = tuple(
            _PView(p.addr, dict(p.cmdlog.chosen_values)) for p in sys.proposers
        )


def _mm_handover_check(sys: ModelSystem) -> List[str]:
    """Matchmaker-handover completeness (Section 6, Figure 7): once a new
    matchmaker is bootstrapped and enabled, its log must contain — at the
    same config_id — every round a retired (stopped) matchmaker logged at
    or above the new one's GC watermark.  Losing such an entry is exactly
    the handover bug that lets a later proposer skip intersecting a live
    configuration."""
    out: List[str] = []
    mms = sys.matchmakers
    retired = [n for n in mms if n.stopped]
    if not retired:
        return out
    for nm in mms:
        if nm.stopped or not (nm.enabled and nm.bootstrapped):
            continue
        for om in retired:
            for j, c in om.log.items():
                if j < nm.gc_watermark:
                    continue
                got = nm.log.get(j)
                if got is None or got.config_id != c.config_id:
                    out.append(
                        f"mm handover lost ({j}, config {c.config_id}): "
                        f"retired {om.addr} logged it, enabled {nm.addr} "
                        f"has {got!r}"
                    )
    return out


@dataclass(frozen=True)
class ModelFamily:
    name: str
    build: Callable[[], ModelSystem]
    doc: str = ""


FAMILIES: Dict[str, ModelFamily] = {}


def _family(name: str, doc: str = "") -> Callable:
    def deco(fn: Callable[[], ModelSystem]) -> Callable[[], ModelSystem]:
        FAMILIES[name] = ModelFamily(name, fn, doc)
        return fn

    return deco


def resolve_family(family: Any) -> ModelFamily:
    if isinstance(family, ModelFamily):
        return family
    try:
        return FAMILIES[family]
    except KeyError:
        raise KeyError(
            f"unknown model family {family!r} (have {sorted(FAMILIES)})"
        ) from None


class MatchmakerAcceptor(Matchmaker, Acceptor):
    """One box serving both the matchmaker and the acceptor role — the
    third node of the 3-node single-decree family.  ``@on`` dispatch
    tables are assembled over the whole MRO
    (``runtime.ProtocolNode.__init_subclass__``), so both roles' handlers
    coexist on one address."""

    def mc_state(self) -> Dict[str, Any]:
        st = Matchmaker.persistent_state(self)
        st.update(Acceptor.persistent_state(self))
        return st


class PruneHappyProposer(SingleDecreeProposer):
    """Deliberately broken — the mutation self-test.

    Optimization 4 (the paper's Section 4) lets a proposer skip Phase 1
    quorums for history configurations in rounds below the highest round
    it saw a vote in.  This mutant applies that pruning rule with an
    unconditional floor: it clears the matchmakers' history before
    Phase 1 ever runs, so it never observes prior votes and proposes its
    own value over one already chosen.  The explorer must find the
    interleaving that turns this into a double-choose."""

    @on(m.MatchB)
    def _on_match_b(self, src: Address, msg: m.MatchB) -> None:
        if self._phase != "matchmaking" or msg.round != self.round:
            return
        self._match_acks[src] = msg
        if len(self._match_acks) < self.f + 1:
            return
        self.history = {}  # BUG: pruning floor treated as +inf
        self.oracle.on_matchmaking_complete(0)
        self._phase = "phase1"
        self._finish_phase1()


def _build_single_decree(proposer_cls: type) -> ModelSystem:
    sim = Simulator(seed=0, net=mc_network())
    oracle = Oracle()
    sim.register(MatchmakerAcceptor("n0"))

    def provider(attempt: int) -> Configuration:
        return Configuration.majority(attempt, ("n0",))

    props = []
    for i, val in ((0, "A"), (1, "B")):
        p = proposer_cls(
            f"p{i}",
            i,
            matchmakers=("n0",),
            oracle=oracle,
            config_provider=provider,
            f=0,
            retry=False,  # no timers: the frontier is pure deliveries
        )
        sim.register(p)
        props.append((p, val))
    for p, val in props:
        p.propose(val)
    return ModelSystem(
        sim,
        oracle,
        proposers=tuple(p for p, _ in props),
        fault_targets=("p0", "p1", "n0"),
        f=0,
    )


@_family(
    "single_decree",
    doc="2 proposers racing different values through one combined "
    "matchmaker+acceptor (f=0); exhaustively explorable.",
)
def _single_decree() -> ModelSystem:
    return _build_single_decree(SingleDecreeProposer)


@_family(
    "single_decree_mutated",
    doc="Mutation self-test: proposers prune the entire Phase-1 history "
    "(broken Opt 4); the explorer must find the double-choose.",
)
def _single_decree_mutated() -> ModelSystem:
    return _build_single_decree(PruneHappyProposer)


@_family(
    "mm_reconfig",
    doc="1 proposer racing a Section-6 matchmaker reconfiguration "
    "(old combined box -> fresh matchmaker); bounded exploration.",
)
def _mm_reconfig() -> ModelSystem:
    sim = Simulator(seed=0, net=mc_network())
    oracle = Oracle()
    sim.register(MatchmakerAcceptor("m0"))  # old matchmaker + the acceptor
    sim.register(Matchmaker("m1", enabled=False))  # bootstrap target

    def provider(attempt: int) -> Configuration:
        return Configuration.majority(attempt, ("m0",))

    p = SingleDecreeProposer(
        "p0",
        0,
        matchmakers=("m0",),
        oracle=oracle,
        config_provider=provider,
        f=0,
        retry=True,  # retries chase the moving matchmaker set
        retry_backoff=0.05,
        max_attempts=3,
    )
    sim.register(p)
    coord = MMReconfigCoordinator(
        "c0",
        0,
        f=0,
        on_complete=lambda new_set: setattr(p, "matchmakers", tuple(new_set)),
        retry_timeout=0.25,
    )
    sim.register(coord)
    p.propose("A")
    coord.reconfigure(("m0",), ("m1",))
    return ModelSystem(
        sim,
        oracle,
        proposers=(p,),
        fault_targets=("p0", "c0"),
        f=0,
    )


# --------------------------------------------------------------------------
# Bounds, results
# --------------------------------------------------------------------------
FAULT_KINDS = ("crash", "restart", "pause", "resume", "drop", "dup")


@dataclass(frozen=True)
class MCConfig:
    """Bounds and features of one exploration run.

    Every bound lands in ``MCResult.bounds`` (and BENCH_mc.json), so a
    truncated search is always visible in the artifact, never silent."""

    max_depth: int = 24  # events per trace
    max_states: int = 1_000_000  # states expanded before giving up
    fault_budget: int = 0  # fault choices per trace
    faults: Tuple[str, ...] = ("crash", "restart")
    fault_targets: Optional[Tuple[Address, ...]] = None  # None = family's
    timer_budget: Optional[int] = None  # timer fires per trace (None = depth-bound only)
    dpor: bool = True
    fingerprints: bool = True
    check_each_step: bool = True
    shrink: bool = True
    shrink_probes: int = 200
    shrink_times: bool = True


# Tier-1 / nightly presets.  "quick" must exhaust the single-decree family
# with a crash+restart budget inside the tier-1 time budget.
PRESETS: Dict[str, MCConfig] = {
    "quick": MCConfig(max_depth=18, max_states=200_000, fault_budget=2),
    "deep": MCConfig(
        max_depth=26,
        max_states=2_000_000,
        fault_budget=3,
        faults=("crash", "restart", "drop", "dup", "pause", "resume"),
        timer_budget=4,
    ),
}


@dataclass
class MCResult:
    family: str
    states: int = 0  # DFS states expanded
    transitions: int = 0  # fresh choices applied
    replays: int = 0  # fork-by-replay rebuilds
    replay_transitions: int = 0  # choices re-applied during rebuilds
    terminals: int = 0  # quiescent traces reached
    depth_cutoffs: int = 0  # traces cut by max_depth
    fingerprint_hits: int = 0  # states pruned as revisited
    sleep_skipped: int = 0  # choices pruned by DPOR sleep sets
    max_frontier: int = 0
    complete: bool = True  # frontier exhausted within every bound
    wall: float = 0.0
    violation: Optional[List[str]] = None
    counterexample: Optional[Schedule] = None
    shrunk: Optional[Schedule] = None
    bounds: Dict[str, Any] = field(default_factory=dict)

    @property
    def found(self) -> bool:
        return self.violation is not None

    @property
    def states_per_sec(self) -> float:
        return self.states / self.wall if self.wall > 0 else 0.0

    def replay_line(self) -> Optional[str]:
        """The one-line reproduction token (mirrors scenarios' REPLAY)."""
        if self.counterexample is None:
            return None
        return f"MC-REPLAY (family={self.family!r}, schedule={self.counterexample!r})"

    def to_json(self) -> Dict[str, Any]:
        return {
            "family": self.family,
            "states": self.states,
            "transitions": self.transitions,
            "replays": self.replays,
            "replay_transitions": self.replay_transitions,
            "terminals": self.terminals,
            "depth_cutoffs": self.depth_cutoffs,
            "fingerprint_hits": self.fingerprint_hits,
            "sleep_skipped": self.sleep_skipped,
            "max_frontier": self.max_frontier,
            "complete": self.complete,
            "wall_sec": round(self.wall, 6),
            "states_per_sec": round(self.states_per_sec, 1),
            "violation": self.violation,
            "counterexample": (
                repr(self.counterexample) if self.counterexample else None
            ),
            "shrunk": repr(self.shrunk) if self.shrunk else None,
            "bounds": dict(self.bounds),
        }


# --------------------------------------------------------------------------
# Choice application (shared by exploration and replay)
# --------------------------------------------------------------------------
# A choice is ("fire", seq, target, event_kind) or
# (fault_kind, key, target, "fault") — plain tuples so sleep sets hash and
# compare across rebuilt states.
Choice = Tuple[str, Any, Optional[Address], str]


def _apply_choice(sys: ModelSystem, c: Choice) -> Optional[List[str]]:
    """Apply one choice; returns violations if the oracle trips mid-step."""
    sim = sys.sim
    try:
        kind = c[0]
        if kind == "fire":
            sim.run_event(c[1])
        elif kind == "crash":
            sim.crash(c[1])  # kill -9
        elif kind == "restart":
            sim.restart(c[1])
        elif kind == "pause":
            sim.pause(c[1])
        elif kind == "resume":
            sim.resume(c[1])
        elif kind == "drop":
            sim.discard_event(c[1])
        elif kind == "dup":
            sim.duplicate_event(c[1])
        else:  # pragma: no cover - vocabulary is closed
            raise ValueError(f"unknown choice {c!r}")
    except SafetyViolation as exc:
        return [f"oracle: {exc}"]
    return None


def _independent(a: Choice, b: Choice) -> bool:
    """Two choices commute iff they touch disjoint nodes.  Fault choices
    additionally contend for the shared per-trace fault budget, so they
    are always mutually dependent."""
    if a[0] != "fire" and b[0] != "fire":
        return False
    ta, tb = a[2], b[2]
    return ta is not None and tb is not None and ta != tb


def _choice_to_fault(c: Choice) -> Any:
    kind = c[0]
    if kind == "fire":
        return Fire(seq=c[1])
    if kind == "crash":
        return Crash(addr=c[1])
    if kind == "restart":
        return Restart(addr=c[1])
    if kind == "pause":
        return Pause(addr=c[1])
    if kind == "resume":
        return Resume(addr=c[1])
    if kind == "drop":
        return DropEvent(seq=c[1])
    if kind == "dup":
        return DupEvent(seq=c[1])
    raise ValueError(f"unknown choice {c!r}")  # pragma: no cover


def trace_to_schedule(family_name: str, trace: Tuple[Choice, ...]) -> Schedule:
    """A violating trace as a one-line replayable ``nemesis.Schedule``.
    Timestamps are ordinals — ``replay`` applies events in list order."""
    return Schedule(
        name=f"mc:{family_name}",
        seed=0,
        events=tuple(
            Event(at=float(i), fault=_choice_to_fault(c))
            for i, c in enumerate(trace)
        ),
    )


def _fault_to_choice(sys: ModelSystem, fault: Any) -> Optional[Choice]:
    """Map a schedule fault back to an applicable choice, or None if it no
    longer applies (ddmin probes remove prefix events, so later seqs may
    never be allocated — such probes simply skip the dangling event)."""
    sim = sys.sim
    t = type(fault)
    if t is Fire:
        for seq, rec in sim.pending_events():
            if seq == fault.seq:
                return ("fire", seq, event_target(rec), event_kind(rec))
        return None
    if t in (DropEvent, DupEvent):
        kind = "drop" if t is DropEvent else "dup"
        for seq, rec in sim.pending_events():
            if seq == fault.seq and event_kind(rec) == "deliver":
                return (kind, seq, event_target(rec), "fault")
        return None
    if t is Crash:
        node = sim.nodes.get(fault.addr)
        return ("crash", fault.addr, fault.addr, "fault") if node and not node.failed else None
    if t is Restart:
        node = sim.nodes.get(fault.addr)
        return ("restart", fault.addr, fault.addr, "fault") if node and node.failed else None
    if t is Pause:
        node = sim.nodes.get(fault.addr)
        if node and not node.failed and fault.addr not in sim._paused:
            return ("pause", fault.addr, fault.addr, "fault")
        return None
    if t is Resume:
        return (
            ("resume", fault.addr, fault.addr, "fault")
            if fault.addr in sim._paused
            else None
        )
    return None  # foreign fault vocabulary: not applicable to MC replay


def _describe_choice(sys: ModelSystem, c: Choice) -> str:
    if c[0] == "fire":
        for seq, rec in sys.sim.pending_events():
            if seq == c[1]:
                k = event_kind(rec)
                if k == "deliver":
                    return (
                        f"deliver #{seq} {rec.src}->{rec.dst} "
                        f"{type(rec.msg).__name__}"
                    )
                if k == "timer":
                    return f"timer #{seq} @{rec.node.addr}"
                return f"{k} #{seq}"
        return f"fire #{c[1]}"
    return f"{c[0]} {c[1]}"


@dataclass
class ReplayResult:
    violations: List[str]
    event_log: List[str]
    applied: int = 0
    skipped: int = 0

    @property
    def safe(self) -> bool:
        return not self.violations


def replay(family: Any, schedule: Schedule, *, check_each_step: bool = True) -> ReplayResult:
    """Re-run a counterexample schedule against a fresh family build.

    Deterministic: the same schedule always produces the same event log
    and the same violations.  Events apply in list order; inapplicable
    events (dangling seqs in ddmin probes) are skipped and counted."""
    fam = resolve_family(family)
    sys = fam.build()
    log: List[str] = []
    violations: List[str] = []
    applied = skipped = 0
    for ev in schedule.events:
        c = _fault_to_choice(sys, ev.fault)
        if c is None:
            skipped += 1
            log.append(f"skip {ev.fault!r}")
            continue
        log.append(_describe_choice(sys, c))
        applied += 1
        viol = _apply_choice(sys, c)
        if viol is None and check_each_step:
            viol = sys.check() or None
        if viol:
            violations = viol
            break
    if not violations:
        violations = sys.check()
    return ReplayResult(
        violations=list(violations), event_log=log, applied=applied, skipped=skipped
    )


def shrink_counterexample(
    family: Any,
    schedule: Schedule,
    *,
    max_probes: int = 200,
    shrink_times: bool = True,
) -> Schedule:
    """Minimize a counterexample through the scenarios ddmin machinery.

    ``shrink_schedule`` reduces the event subsequence to 1-minimal;
    ``shrink_timing`` then compresses the (ordinal) timestamps — replay
    ignores absolute times, so this renumbers the steps tightly.  Both
    are deterministic: shrinking twice yields the same schedule."""
    fam = resolve_family(family)

    def still_fails(s: Schedule) -> bool:
        return bool(replay(fam, s).violations)

    shrunk = shrink_schedule(schedule, still_fails, max_probes=max_probes)
    if shrink_times:
        shrunk = shrink_timing(
            shrunk, still_fails, max_probes=max(10, max_probes // 4)
        )
    return shrunk


# --------------------------------------------------------------------------
# Fingerprints
# --------------------------------------------------------------------------
_CELL_TYPES = (str, int, float, bool, tuple, frozenset, Round, type(NEG_INF))


def _event_fp(rec: Any) -> Tuple[Any, ...]:
    """A pending heap record's identity, excluding times and seq ids."""
    kind = event_kind(rec)
    if kind == "deliver":
        return ("m", rec.src, rec.dst, wire.encode(rec.msg))
    if kind == "frame":
        return ("f", rec.src, rec.dst, tuple(wire.encode(x) for x in rec.msgs))
    if kind == "timer":
        fn = rec.fn
        # Timer identity: owner + callback site + scalar closure cells
        # (e.g. the round a retry is pinned to).  Closure cells holding
        # richer objects are skipped — coarser, still deterministic.
        cells = tuple(
            repr(cell.cell_contents)
            for cell in (getattr(fn, "__closure__", None) or ())
            if isinstance(cell.cell_contents, _CELL_TYPES)
        )
        return ("t", rec.node.addr, getattr(fn, "__qualname__", repr(fn)), cells)
    return ("c", getattr(rec.fn, "__qualname__", "call"), ())


def fingerprint(sys: ModelSystem, faults_left: int = 0, timers_left: int = 0) -> bytes:
    """Canonical hash of a model-system state.

    Covers: every node's ``mc_state()`` (+ class, failed, paused), the
    multiset of in-flight messages and pending timers, the oracle's
    chosen record and violations, and the remaining fault/timer budgets
    (two states that differ only in remaining budget have different
    futures).  Excludes: delivery times, seq ids, telemetry."""
    sim = sys.sim
    nodes = []
    for addr in sorted(sim.nodes):
        n = sim.nodes[addr]
        nodes.append(
            (
                addr,
                type(n).__name__,
                bool(n.failed),
                addr in sim._paused,
                n.mc_state(),
            )
        )
    pend = sorted(_event_fp(rec) for _, rec in sim.pending_events())
    oracle = (
        {slot: wire.encode_value(rec.value) for slot, rec in sys.oracle.chosen.items()},
        tuple(sys.oracle.violations),
    )
    blob = wire.encode_canonical(
        (tuple(nodes), tuple(pend), oracle, int(faults_left), int(min(timers_left, 1 << 30)))
    )
    return hashlib.blake2b(blob, digest_size=16).digest()


# --------------------------------------------------------------------------
# The explorer
# --------------------------------------------------------------------------
class _Budget(Exception):
    """Unwinds the DFS when max_states is exhausted."""


class _Found(Exception):
    """Unwinds the DFS at the first invariant violation."""


class _Explorer:
    def __init__(self, family: ModelFamily, cfg: MCConfig):
        self.family = family
        self.cfg = cfg
        self.res = MCResult(
            family=family.name,
            bounds={
                "max_depth": cfg.max_depth,
                "max_states": cfg.max_states,
                "fault_budget": cfg.fault_budget,
                "faults": list(cfg.faults) if cfg.fault_budget else [],
                "fault_targets": list(cfg.fault_targets or ()) or None,
                "timer_budget": cfg.timer_budget,
                "dpor": cfg.dpor,
                "fingerprints": cfg.fingerprints,
                "check_each_step": cfg.check_each_step,
            },
        )
        # fingerprint -> (min depth seen, intersection of sleep sets seen)
        self.visited: Dict[bytes, Tuple[int, FrozenSet[Choice]]] = {}

    def run(self) -> MCResult:
        res = self.res
        t0 = time.perf_counter()
        sys = self.family.build()
        timers = (
            self.cfg.timer_budget if self.cfg.timer_budget is not None else 1 << 30
        )
        try:
            self._dfs(sys, (), frozenset(), 0, self.cfg.fault_budget, timers)
        except _Budget:
            res.complete = False
        except _Found:
            res.complete = False  # stopped at the first counterexample
        res.wall = time.perf_counter() - t0
        if res.counterexample is not None and self.cfg.shrink:
            res.shrunk = shrink_counterexample(
                self.family,
                res.counterexample,
                max_probes=self.cfg.shrink_probes,
                shrink_times=self.cfg.shrink_times,
            )
        return res

    def _found(self, trace: Tuple[Choice, ...], violations: List[str]) -> None:
        self.res.violation = list(violations)
        self.res.counterexample = trace_to_schedule(self.family.name, trace)

    def _rebuild(self, trace: Tuple[Choice, ...]) -> ModelSystem:
        """Fork-by-replay: rebuild the family and re-apply the prefix."""
        res = self.res
        res.replays += 1
        sys = self.family.build()
        for c in trace:
            viol = _apply_choice(sys, c)
            res.replay_transitions += 1
            if viol:  # pragma: no cover - determinism guard
                raise AssertionError(f"nondeterministic replay: {viol}")
        return sys

    def _choices(
        self, sys: ModelSystem, faults_left: int, timers_left: int
    ) -> List[Choice]:
        cfg = self.cfg
        sim = sys.sim
        out: List[Choice] = []
        droppable: List[Tuple[int, Address]] = []
        for seq, rec in sim.pending_events():
            kind = event_kind(rec)
            tgt = event_target(rec)
            if tgt is not None:
                node = sim.nodes.get(tgt)
                if node is None:
                    continue
                if node.failed or tgt in sim._paused:
                    # A down/wedged node's mail waits (asynchronous net:
                    # arbitrary delay until after restart/resume); the
                    # lost-message case is the explicit drop choice.
                    if kind == "deliver":
                        droppable.append((seq, tgt))
                    continue
            if kind == "timer" and timers_left <= 0:
                continue
            out.append(("fire", seq, tgt, kind))
            if kind == "deliver":
                droppable.append((seq, tgt))
        if faults_left > 0:
            targets = cfg.fault_targets or sys.fault_targets
            for addr in targets:
                node = sim.nodes.get(addr)
                if node is None:
                    continue
                if "crash" in cfg.faults and not node.failed:
                    out.append(("crash", addr, addr, "fault"))
                if "restart" in cfg.faults and node.failed:
                    out.append(("restart", addr, addr, "fault"))
                if (
                    "pause" in cfg.faults
                    and not node.failed
                    and addr not in sim._paused
                ):
                    out.append(("pause", addr, addr, "fault"))
                if "resume" in cfg.faults and addr in sim._paused:
                    out.append(("resume", addr, addr, "fault"))
            if "drop" in cfg.faults:
                out.extend(("drop", seq, tgt, "fault") for seq, tgt in droppable)
            if "dup" in cfg.faults:
                out.extend(("dup", seq, tgt, "fault") for seq, tgt in droppable)
        return out

    def _dfs(
        self,
        sys: ModelSystem,
        trace: Tuple[Choice, ...],
        sleep: FrozenSet[Choice],
        depth: int,
        faults_left: int,
        timers_left: int,
    ) -> None:
        cfg = self.cfg
        res = self.res
        res.states += 1
        if res.states > cfg.max_states:
            raise _Budget()
        if cfg.check_each_step or depth == 0:
            viol = sys.check()
            if viol:
                self._found(trace, viol)
                raise _Found()
        choices = self._choices(sys, faults_left, timers_left)
        if len(choices) > res.max_frontier:
            res.max_frontier = len(choices)
        if not choices:
            res.terminals += 1
            viol = sys.check()  # terminal check, always
            if viol:
                self._found(trace, viol)
                raise _Found()
            return
        if depth >= cfg.max_depth:
            res.depth_cutoffs += 1
            res.complete = False
            viol = sys.check()
            if viol:
                self._found(trace, viol)
                raise _Found()
            return
        if cfg.fingerprints:
            fp = fingerprint(sys, faults_left, timers_left)
            prev = self.visited.get(fp)
            if prev is not None and prev[0] <= depth and prev[1] <= sleep:
                # The stored visit had at least as much depth budget and a
                # smaller-or-equal sleep set: everything reachable from
                # here was (or will be) covered there.
                res.fingerprint_hits += 1
                return
            self.visited[fp] = (
                depth if prev is None else min(prev[0], depth),
                sleep if prev is None else (prev[1] & sleep),
            )
        if cfg.dpor:
            live = [c for c in choices if c not in sleep]
            res.sleep_skipped += len(choices) - len(live)
        else:
            live = choices
        cur: Optional[ModelSystem] = sys
        for i, c in enumerate(live):
            if cur is None:
                cur = self._rebuild(trace)
            viol = _apply_choice(cur, c)
            res.transitions += 1
            if viol:
                self._found(trace + (c,), viol)
                raise _Found()
            if cfg.dpor:
                child_sleep = frozenset(
                    s for s in sleep if _independent(s, c)
                ) | frozenset(
                    live[j] for j in range(i) if _independent(live[j], c)
                )
            else:
                child_sleep = frozenset()
            self._dfs(
                cur,
                trace + (c,),
                child_sleep,
                depth + 1,
                faults_left - (c[0] != "fire"),
                timers_left - (1 if (c[0] == "fire" and c[3] == "timer") else 0),
            )
            cur = None  # consumed by the child subtree; siblings replay


def explore(family: Any, config: Optional[MCConfig] = None, **overrides: Any) -> MCResult:
    """Run the bounded model checker over one model family.

    ``family`` is a name from :data:`FAMILIES` or a :class:`ModelFamily`;
    ``config`` an :class:`MCConfig` (default bounds otherwise), with
    keyword overrides applied on top (``explore("single_decree",
    fault_budget=2)``).  Stops at the first invariant violation and emits
    a replayable, ddmin-shrunk counterexample schedule."""
    fam = resolve_family(family)
    cfg = config or MCConfig()
    if overrides:
        cfg = replace(cfg, **overrides)
    return _Explorer(fam, cfg).run()
