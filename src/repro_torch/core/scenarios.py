"""Adversarial reconfiguration scenarios: nemesis schedules + live workloads.

Each scenario composes a seeded :class:`nemesis.Schedule` with a live
client workload against the paper's Section 8 topology and checks the
full invariant suite (``nemesis.check_invariants``) after every injected
event and once more at the end.  The same scenario/seed pair runs on the
deterministic ``Simulator`` *and* on ``net.AsyncTransport`` — this is the
PR-1 transport-parity test extended to faulty schedules: wall-clock
scheduling makes the asyncio interleavings different, so parity under
faults is *safety* parity (every invariant holds on both transports), not
log equality.

The catalog (paper sections each one stresses):

  ====================================  =============================
  scenario                              paper
  ====================================  =============================
  traffic_during_reconfig               Sections 4.3/4.4, 8 (Fig. 9)
  leader_kill9_mid_phase2               Sections 3.4, 4.1 (takeover)
  mm_reconfig_under_partition           Section 6
  acceptor_swap_storm                   Sections 2.1, 4, 8.1
  fast_paxos_recovery                   Section 7 (Algorithm 5)
  gc_during_failover                    Section 5 (Scenarios 1-3)
  shard_leader_failover                 sharded log plane (ARCHITECTURE)
  router_storm                          router relay fast path (Layer 2.5)
  pause_during_reconfig                 gray failures (SIGSTOP; proc plane)
  clock_skew_churn                      Section 2.1 (no clock sync)
  ====================================  =============================

Failing schedules shrink: ``shrink_schedule`` bisects a failing
``(seed, schedule)`` to a minimal event subsequence (ddmin), and
``shrink_failing_scenario`` wires it to a real scenario re-run.

Every failure raises :class:`ScenarioFailure` whose message leads with the
one-line ``(seed, schedule)`` replay token; re-running
``run_scenario(name, seed)`` regenerates a value-equal schedule and, on
the simulator, a byte-for-byte identical event log.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .deploy import ClusterSpec, make_transport
from .fast_paxos import FastAcceptor, FastClient, FastCoordinator
from .matchmaker import Matchmaker
from .nemesis import (
    ClockSkew,
    Crash,
    DiskLoss,
    Event,
    Heal,
    MMReconfigure,
    Nemesis,
    Partition,
    Pause,
    ReconfigureRandom,
    Restart,
    Resume,
    Schedule,
    StartClients,
    StopClients,
    Storm,
    Takeover,
)
from .oracle import Oracle, SafetyViolation
from .proposer import Options
from .quorums import Configuration
from .replica import KVStoreSM
from .sim import NetworkConfig


class ScenarioFailure(AssertionError):
    """A scenario-harness failure; the message leads with the replay tuple."""


# raise_if_unsafe auto-minimizes failing sim schedules through ddmin before
# raising, so the assertion message carries both the full replay token and a
# shrunken one.  The probe budget is deliberately small: this runs inside a
# failing test, where dozens of re-runs are acceptable but hundreds are not.
AUTO_SHRINK = True
AUTO_SHRINK_PROBES = 40


@dataclass
class ScenarioResult:
    name: str
    seed: int
    transport: str
    replay: str                      # one-line (seed, schedule) token
    event_log: List[str]
    violations: List[str]
    chosen_slots: int
    completed_commands: int
    steady_throughput: float = 0.0   # cmds/sec before the first fault
    faulty_throughput: float = 0.0   # cmds/sec while the nemesis is active
    schedule: Optional[Schedule] = None  # the schedule actually run

    @property
    def safe(self) -> bool:
        return not self.violations

    def raise_if_unsafe(self, shrink: Optional[bool] = None) -> "ScenarioResult":
        if not self.violations:
            return self
        msg = (
            f"REPLAY {self.replay}\n"
            f"scenario {self.name!r} seed {self.seed} on {self.transport}: "
            f"{len(self.violations)} invariant violation(s):\n  "
            + "\n  ".join(self.violations)
        )
        if shrink is None:
            shrink = AUTO_SHRINK and self.transport == "sim" and self.schedule is not None
        if shrink and self.schedule is not None:
            try:
                small = shrink_schedule(
                    self.schedule,
                    lambda s: not run_scenario(
                        self.name, self.seed, transport=self.transport, schedule=s
                    ).safe,
                    max_probes=AUTO_SHRINK_PROBES,
                )
                msg += (
                    f"\nSHRUNK (ddmin, {len(small.events)}/"
                    f"{len(self.schedule.events)} events): REPLAY "
                    f"(seed={self.seed}, schedule={small!r})"
                )
            except Exception as exc:  # shrinking must never mask the failure
                msg += f"\nSHRUNK: unavailable ({type(exc).__name__}: {exc})"
        raise ScenarioFailure(msg)


@dataclass
class _Scenario:
    cluster: ClusterSpec
    schedule: Schedule
    net: NetworkConfig
    horizon: float
    # [t0, t1) windows for the throughput comparison
    steady_window: Tuple[float, float]
    faulty_window: Tuple[float, float]


def _rng(name: str, seed: int) -> random.Random:
    return random.Random(f"{name}:{seed}")


def _jitter(rng: random.Random, t: float, spread: float = 0.02) -> float:
    return t + rng.uniform(0.0, spread)


# --------------------------------------------------------------------------
# Scenario builders (standard Section 8 topology, f=1)
# --------------------------------------------------------------------------
def _base_cluster(n_clients: int = 2) -> ClusterSpec:
    return ClusterSpec(
        f=1,
        n_clients=n_clients,
        sm_factory=KVStoreSM,
        client_retry_timeout=0.06,
        options=Options(phase2_retry_timeout=0.05),
    )


def _kv_op_factory(client_index: int):
    """Deterministic mixed set/get workload over a small key space, so the
    linearizability check compares real (order-sensitive) results instead
    of a constant 'ok'."""

    def factory(n: int):
        if n % 3 == 2:
            return ("get", f"k{n % 5}")
        return ("set", f"k{n % 5}", (client_index, n))

    return factory


def _all_addrs(spec: ClusterSpec) -> Tuple[str, ...]:
    return (
        spec.all_proposer_addrs()
        + spec.all_acceptor_addrs()
        + spec.matchmaker_addrs()
        + spec.standby_matchmaker_addrs()
        + spec.replica_addrs()
        + ("mmcoord",)
        + ((spec.router_addr(),) if spec.num_shards > 1 else ())
        + tuple(f"c{i}" for i in range(spec.n_clients))
    )


def _traffic_during_reconfig(seed: int) -> _Scenario:
    """Pipelined command traffic while the leader swaps acceptor configs
    (Optimizations 1/2: reconfiguration must not stall the hot path)."""
    rng = _rng("traffic_during_reconfig", seed)
    events = [Event(0.02, StartClients())]
    for k in range(3):
        events.append(Event(_jitter(rng, 0.08 + 0.1 * k), ReconfigureRandom()))
    events.append(Event(0.45, StopClients()))
    return _Scenario(
        cluster=_base_cluster(),
        schedule=Schedule("traffic_during_reconfig", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.6,
        steady_window=(0.02, 0.08),
        faulty_window=(0.08, 0.4),
    )


def _leader_kill9_mid_phase2(seed: int) -> _Scenario:
    """kill -9 the leader while Phase 2 traffic is in flight; a follower
    takes over (full Phase 1); the corpse restarts later — sometimes
    without wiping volatile state, i.e. still believing it leads."""
    rng = _rng("leader_kill9_mid_phase2", seed)
    clean = rng.random() < 0.3
    wipe = rng.random() < 0.7
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.1), Crash("p0", clean=clean)),
        Event(_jitter(rng, 0.16), Takeover(1)),
        Event(_jitter(rng, 0.3), Restart("p0", wipe_volatile=wipe)),
        Event(0.45, StopClients()),
    ]
    return _Scenario(
        cluster=_base_cluster(),
        schedule=Schedule("leader_kill9_mid_phase2", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.6,
        steady_window=(0.02, 0.1),
        faulty_window=(0.1, 0.4),
    )


def _mm_reconfig_under_partition(seed: int) -> _Scenario:
    """Section 6 matchmaker reconfiguration onto the standby set while a
    partition cuts 1-2 old matchmakers (and sometimes the coordinator)
    off; heals mid-protocol so retries finish the job."""
    rng = _rng("mm_reconfig_under_partition", seed)
    spec = _base_cluster()
    mms = list(spec.matchmaker_addrs())
    standby = spec.standby_matchmaker_addrs()
    # The cut can hit old matchmakers or the reconfiguration coordinator
    # itself (its retry timers must finish the job after the heal).
    cut = tuple(rng.sample(mms + ["mmcoord"], rng.choice([1, 2])))
    rest = tuple(a for a in _all_addrs(spec) if a not in cut)
    symmetric = rng.random() < 0.7
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.06), Partition(cut, rest, symmetric=symmetric)),
        Event(_jitter(rng, 0.1), MMReconfigure(standby)),
        Event(_jitter(rng, 0.28), Heal()),
        # Force a round change so the *new* matchmaker set actually serves
        # a Matchmaking phase after the handover.
        Event(_jitter(rng, 0.36), ReconfigureRandom()),
        Event(0.5, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("mm_reconfig_under_partition", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.65,
        steady_window=(0.02, 0.06),
        faulty_window=(0.06, 0.45),
    )


def _acceptor_swap_storm(seed: int) -> _Scenario:
    """Acceptor reconfigurations under a message dup/drop/delay storm on
    the acceptor pool — the asynchronous-model adversary of Section 2.1
    aimed straight at the quorum traffic."""
    rng = _rng("acceptor_swap_storm", seed)
    spec = _base_cluster()
    acc = spec.acceptor_addrs()
    storm = Storm(
        drop=rng.uniform(0.05, 0.2),
        dup=rng.uniform(0.1, 0.3),
        delay=rng.uniform(0.5e-3, 3e-3),
        targets=acc,
        tag="acceptor-storm",
    )
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.06), storm),
        Event(_jitter(rng, 0.12), ReconfigureRandom()),
        Event(_jitter(rng, 0.22), ReconfigureRandom()),
        Event(_jitter(rng, 0.34), Heal()),
        Event(0.5, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("acceptor_swap_storm", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.65,
        steady_window=(0.02, 0.06),
        faulty_window=(0.06, 0.45),
    )


def _gc_during_failover(seed: int) -> _Scenario:
    """Garbage collection racing a leader failover: old configurations
    are being retired (Scenarios 1-3) when the leader dies; the successor
    must re-derive a consistent history and GC must never outrun the
    f+1-replica durability bar."""
    rng = _rng("gc_during_failover", seed)
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.06), ReconfigureRandom()),   # creates old configs
        Event(_jitter(rng, 0.12), ReconfigureRandom()),   # + GC churn
        Event(_jitter(rng, 0.16), Crash("p0", clean=False)),
        Event(_jitter(rng, 0.22), Takeover(1)),
        Event(_jitter(rng, 0.34), Restart("p0", wipe_volatile=True)),
        Event(_jitter(rng, 0.4), ReconfigureRandom()),
        Event(0.52, StopClients()),
    ]
    return _Scenario(
        cluster=_base_cluster(),
        schedule=Schedule("gc_during_failover", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.68,
        steady_window=(0.02, 0.06),
        faulty_window=(0.06, 0.5),
    )


def _shard_leader_failover(seed: int) -> _Scenario:
    """Sharded log plane under fire: kill one shard's leader mid-Phase-2
    while the other shard keeps serving its share of the slot space; the
    dead shard's follower takes over (full Phase 1 + noop fill-in of the
    shard's owned holes) and then reconfigures that shard via the shared
    matchmakers — without touching the surviving shard's configuration.
    Clients route through the ShardRouter, so the dead window also
    exercises retry-driven re-routing to the shard's new leader."""
    rng = _rng("shard_leader_failover", seed)
    spec = ClusterSpec(
        f=1,
        n_clients=4,
        sm_factory=KVStoreSM,
        client_retry_timeout=0.06,
        options=Options(phase2_retry_timeout=0.05),
        num_shards=2,
        route_via_router=True,
    )
    victim = rng.choice([0, 1])
    leader = spec.shard_proposer_addrs(victim)[0]
    clean = rng.random() < 0.3
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.1), Crash(leader, clean=clean)),
        Event(_jitter(rng, 0.16), Takeover(1, shard=victim)),
        # Reconfigure the recovered shard via the matchmakers; the other
        # shard reconfigures too, proving the shared matchmaker set keeps
        # the per-shard configuration logs independent.
        Event(_jitter(rng, 0.26), ReconfigureRandom(shard=victim)),
        Event(_jitter(rng, 0.3), ReconfigureRandom(shard=1 - victim)),
        Event(_jitter(rng, 0.36), Restart(leader, wipe_volatile=True)),
        Event(0.5, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("shard_leader_failover", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.68,
        steady_window=(0.02, 0.1),
        faulty_window=(0.1, 0.45),
    )


def _router_storm(seed: int) -> _Scenario:
    """Drop/dup/delay storm aimed straight at the ShardRouter while four
    shards serve coalesced client traffic.  Clients batch their requests
    into sealed envelopes (``client_coalesce=True``), so the router's
    zero-copy relay fast path — slicing already-encoded sub-frames out of
    a :class:`messages.SealedBatch` and re-grouping them per shard leader
    — is exactly what the storm interposes on.  FaultPlane sees the
    pre-encoded envelope view (SealedBatch is never re-wrapped), so every
    drop/dup/delay decision lands on the same message boundaries the
    relay slices at: dropped envelopes must be recovered by client
    retries, duplicated ones deduplicated by command id, delayed ones
    reordered across shards without breaking per-shard FIFO execution."""
    rng = _rng("router_storm", seed)
    spec = ClusterSpec(
        f=1,
        n_clients=4,
        sm_factory=KVStoreSM,
        client_retry_timeout=0.06,
        options=Options(
            phase2_retry_timeout=0.05,
            batch_max=4,
            batch_flush_interval=2e-3,
        ),
        num_shards=4,
        route_via_router=True,
        client_coalesce=True,
    )
    storm = Storm(
        drop=rng.uniform(0.05, 0.2),
        dup=rng.uniform(0.1, 0.3),
        delay=rng.uniform(0.5e-3, 3e-3),
        targets=(spec.router_addr(),),
        tag="router-storm",
    )
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.06), storm),
        Event(_jitter(rng, 0.32), Heal()),
        Event(0.48, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("router_storm", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.64,
        steady_window=(0.02, 0.06),
        faulty_window=(0.06, 0.45),
    )


def _replica_disk_loss(seed: int) -> _Scenario:
    """A replica crashes, its disk is wiped while down, and it restarts
    with nothing — the crash-recovery assumption (synchronously persisted
    state survives) broken for one node.  On restart it must re-sync the
    chosen prefix from its peers before re-acking, while live traffic and
    a reconfiguration keep running.  GC's f+1-replica durability bar
    (Section 5, Scenario 3) is exactly what makes one disk loss
    survivable: the remaining replicas still hold every GC-cleared
    prefix."""
    rng = _rng("replica_disk_loss", seed)
    spec = _base_cluster()
    victim = rng.choice(list(spec.replica_addrs()))
    live_wipe = rng.random() < 0.3  # sometimes wipe a *running* replica
    events = [Event(0.02, StartClients())]
    if live_wipe:
        events.append(Event(_jitter(rng, 0.12), DiskLoss(victim)))
    else:
        events += [
            Event(_jitter(rng, 0.1), Crash(victim, clean=False)),
            Event(_jitter(rng, 0.16), DiskLoss(victim)),
            Event(_jitter(rng, 0.22), Restart(victim)),
        ]
    events += [
        Event(_jitter(rng, 0.3), ReconfigureRandom()),
        Event(0.45, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("replica_disk_loss", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.6,
        steady_window=(0.02, 0.1),
        faulty_window=(0.1, 0.4),
    )


def _pause_during_reconfig(seed: int) -> _Scenario:
    """Gray failure (wedged-but-connected): a matchmaker or an acceptor is
    SIGSTOPped across a reconfiguration window.  Its peers see an open,
    accepting connection the whole time — no RST, no EOF — so only quorum
    logic (the other 2f matchmakers / acceptors answer) keeps both the
    Matchmaking phase and the hot path moving.  On resume the victim's
    entire deferred backlog floods in at once: stale MatchA/Phase2A from
    superseded rounds that it must nack or ignore without ever
    contradicting what the live quorums chose.  The proc backend delivers
    this as a real SIGSTOP/SIGCONT; sim and tcp model it as in-order
    delivery deferral."""
    rng = _rng("pause_during_reconfig", seed)
    spec = _base_cluster()
    pool = list(spec.matchmaker_addrs()) + list(spec.acceptor_addrs())
    victim = rng.choice(pool)
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.07), Pause(victim)),
        Event(_jitter(rng, 0.1), ReconfigureRandom()),
        Event(_jitter(rng, 0.18), ReconfigureRandom()),
        Event(_jitter(rng, 0.26), Resume(victim)),
        Event(_jitter(rng, 0.34), ReconfigureRandom()),
        Event(0.48, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("pause_during_reconfig", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.64,
        steady_window=(0.02, 0.07),
        faulty_window=(0.07, 0.45),
    )


def _clock_skew_churn(seed: int) -> _Scenario:
    """Timer-drift adversary: the leader's clock runs slow (heartbeats,
    Phase-2 retries and flush timers all late) and one acceptor's runs
    fast, while reconfigurations churn.  Safety must be untouched — the
    paper's model has no clock synchronization at all (Section 2.1)."""
    rng = _rng("clock_skew_churn", seed)
    spec = _base_cluster()
    skewed_acc = rng.choice(list(spec.acceptor_addrs()))
    events = [
        Event(0.02, StartClients()),
        Event(_jitter(rng, 0.05), ClockSkew("p0", scale=rng.uniform(1.5, 3.0))),
        Event(
            _jitter(rng, 0.07),
            ClockSkew(skewed_acc, scale=rng.uniform(0.3, 0.8), offset=rng.uniform(0.0, 0.002)),
        ),
        Event(_jitter(rng, 0.12), ReconfigureRandom()),
        Event(_jitter(rng, 0.22), ReconfigureRandom()),
        Event(_jitter(rng, 0.32), Heal()),
        Event(_jitter(rng, 0.38), ReconfigureRandom()),
        Event(0.5, StopClients()),
    ]
    return _Scenario(
        cluster=spec,
        schedule=Schedule("clock_skew_churn", seed, tuple(events)),
        net=NetworkConfig(),
        horizon=0.65,
        steady_window=(0.02, 0.05),
        faulty_window=(0.05, 0.45),
    )


_BUILDERS: Dict[str, Callable[[int], _Scenario]] = {
    "traffic_during_reconfig": _traffic_during_reconfig,
    "leader_kill9_mid_phase2": _leader_kill9_mid_phase2,
    "mm_reconfig_under_partition": _mm_reconfig_under_partition,
    "acceptor_swap_storm": _acceptor_swap_storm,
    "gc_during_failover": _gc_during_failover,
    "shard_leader_failover": _shard_leader_failover,
    "router_storm": _router_storm,
    "replica_disk_loss": _replica_disk_loss,
    "pause_during_reconfig": _pause_during_reconfig,
    "clock_skew_churn": _clock_skew_churn,
}

SCENARIO_NAMES: Tuple[str, ...] = tuple(_BUILDERS) + ("fast_paxos_recovery",)


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------
def build_schedule(name: str, seed: int) -> Schedule:
    """The declarative schedule for (name, seed) — the replay surface."""
    if name == "fast_paxos_recovery":
        return _fast_paxos_schedule(seed)
    return _BUILDERS[name](seed).schedule


def run_scenario(
    name: str,
    seed: int,
    *,
    transport: str = "sim",
    schedule: Optional[Schedule] = None,
) -> ScenarioResult:
    """Run one adversarial scenario; returns the (unraised) result.

    ``transport`` is ``"sim"`` (deterministic, byte-for-byte replayable),
    ``"async"`` (wall-clock asyncio; safety checks only), ``"tcp"``
    (real per-node sockets + binary wire frames; safety checks only), or
    ``"proc"`` (one OS process per node, faults as real POSIX signals,
    invariants checked at teardown over persisted state).
    ``schedule`` overrides the builder's schedule (same cluster/topology)
    — the shrinker re-runs a scenario with event subsequences this way.
    """
    if transport == "proc":
        from .proc import run_proc_scenario

        return run_proc_scenario(name, seed, schedule=schedule)
    if name == "fast_paxos_recovery":
        return _run_fast_paxos(seed, transport, schedule=schedule)
    sc = _BUILDERS[name](seed)
    if schedule is not None:
        sc = _Scenario(
            cluster=sc.cluster,
            schedule=schedule,
            net=sc.net,
            horizon=sc.horizon,
            steady_window=sc.steady_window,
            faulty_window=sc.faulty_window,
        )
    t: Any = make_transport(transport, seed=seed, net=sc.net)
    dep = sc.cluster.instantiate(t)
    for i, c in enumerate(dep.clients):
        c.op_factory = _kv_op_factory(i)
    nem = dep.attach_nemesis(sc.schedule)

    violations: List[str] = []
    try:
        if transport == "sim":
            t.run_until(sc.horizon)
        else:
            t.run(sc.horizon)
    except SafetyViolation as exc:  # oracle raised mid-run
        violations.append(f"oracle: {exc}")
    violations.extend(nem.final_check())

    lat = dep.latencies
    s0, s1 = sc.steady_window
    f0, f1 = sc.faulty_window
    steady = len(lat(s0, s1)) / max(s1 - s0, 1e-9)
    faulty = len(lat(f0, f1)) / max(f1 - f0, 1e-9)
    return ScenarioResult(
        name=name,
        seed=seed,
        transport=transport,
        replay=nem.replay_line(),
        event_log=list(nem.event_log),
        violations=violations,
        chosen_slots=len(dep.oracle.chosen),
        completed_commands=sum(len(c.latencies) for c in dep.clients),
        steady_throughput=steady,
        faulty_throughput=faulty,
        schedule=sc.schedule,
    )


# --------------------------------------------------------------------------
# Fast Paxos coordinated recovery (Section 7) — its own topology
# --------------------------------------------------------------------------
def _fast_paxos_schedule(seed: int) -> Schedule:
    rng = _rng("fast_paxos_recovery", seed)
    acc = ("a0", "a1")
    storm = Storm(
        drop=rng.uniform(0.1, 0.3),
        dup=rng.uniform(0.0, 0.2),
        delay=rng.uniform(0.5e-3, 2e-3),
        targets=acc,
        tag="fast-storm",
    )
    return Schedule(
        "fast_paxos_recovery",
        seed,
        (
            Event(_jitter(rng, 0.005), storm),
            Event(_jitter(rng, 0.12), Heal()),
        ),
    )


class _FastDeps:
    """Just enough deployment shape for Nemesis (no full invariants —
    Fast Paxos here is single-decree with its own oracle check)."""

    def __init__(self, sim: Any):
        self.sim = sim


def _run_fast_paxos(
    seed: int, transport: str, *, schedule: Optional[Schedule] = None
) -> ScenarioResult:
    """Two clients race values into f+1 fast acceptors under an acceptor
    storm; the coordinator must recover conflicts into higher rounds and
    at most one value may ever be chosen (Algorithm 5)."""
    rng = _rng("fast_paxos_recovery", seed)
    if schedule is None:
        schedule = _fast_paxos_schedule(seed)
    net = NetworkConfig()
    t: Any = make_transport(transport, seed=seed, net=net)

    oracle = Oracle()
    mms = [Matchmaker(f"mm{i}") for i in range(3)]
    acc_addrs = ("a0", "a1")  # f+1 = 2 acceptors: the Section 7 headline
    coord = FastCoordinator(
        "coord",
        0,
        matchmakers=tuple(mm.addr for mm in mms),
        oracle=oracle,
        config_provider=lambda attempt: Configuration.fast_f_plus_1(
            attempt, acc_addrs
        ),
        f=1,
    )
    accs = [FastAcceptor(a, learners=("coord",)) for a in acc_addrs]
    clients = [FastClient(f"c{i}", acc_addrs, f"value{i}") for i in range(2)]
    for n in [*mms, *accs, coord, *clients]:
        t.register(n)

    nem = Nemesis(_FastDeps(t), schedule, check=None).arm()
    coord.start_round()
    # Both clients race during the storm (likely conflict); after the heal
    # one client keeps re-proposing so every coordinated-recovery round
    # either adopts the surviving vote (unique V -> classic Phase 2) or
    # gets a fresh fast-path value to choose.
    for i, c in enumerate(clients):
        t.call_at(0.004 + 0.002 * i, c.propose)
    for k in range(12):
        t.call_at(
            0.15 + 0.04 * k + rng.uniform(0.0, 0.01),
            lambda: clients[0].propose() if coord.chosen_value is None else None,
        )

    violations: List[str] = []
    horizon = 2.0
    try:
        if transport == "sim":
            t.run_until(horizon)
        else:
            t.run(0.8, until=lambda: coord.chosen_value is not None)
    except SafetyViolation as exc:
        violations.append(f"oracle: {exc}")

    violations.extend(oracle.violations)
    chosen = {repr(r.value) for r in oracle.chosen.values()}
    if len(chosen) > 1:
        violations.append(f"fast paxos chose two values: {sorted(chosen)}")
    if transport == "sim" and coord.chosen_value is None:
        violations.append("fast paxos: no value chosen after recovery horizon")
    if coord.chosen_value is not None and repr(coord.chosen_value) not in (
        chosen or {repr(coord.chosen_value)}
    ):
        violations.append(
            f"coordinator learned {coord.chosen_value!r} but oracle saw {chosen}"
        )
    return ScenarioResult(
        name="fast_paxos_recovery",
        seed=seed,
        transport=transport,
        replay=nem.replay_line(),
        event_log=list(nem.event_log),
        violations=violations,
        chosen_slots=len(oracle.chosen),
        completed_commands=1 if coord.chosen_value is not None else 0,
        schedule=schedule,
    )


# --------------------------------------------------------------------------
# Schedule shrinking (delta debugging over the event subsequence)
# --------------------------------------------------------------------------
def shrink_schedule(
    schedule: Schedule,
    still_fails: Callable[[Schedule], bool],
    *,
    max_probes: int = 500,
) -> Schedule:
    """Reduce a failing schedule to a (1-)minimal event subsequence.

    Bisecting delta debugging (ddmin): repeatedly try dropping chunks of
    the event list — halves first, then quarters, down to single events —
    keeping any candidate for which ``still_fails`` still returns True.
    The result is 1-minimal w.r.t. the probes made: no single remaining
    event can be removed without the failure disappearing (unless the
    ``max_probes`` budget ran out first).

    ``still_fails`` receives a Schedule value-equal to the original but
    for the event subsequence — for a real scenario failure, pass
    ``lambda s: not run_scenario(name, seed, schedule=s).safe``.  Event
    timestamps are preserved, so a shrunken schedule replays the same
    instants the surviving events originally fired at.
    """
    events: List[Event] = list(schedule.events)

    def mk(evs: List[Event]) -> Schedule:
        return Schedule(schedule.name, schedule.seed, tuple(evs))

    probes = 0

    def probe(evs: List[Event]) -> bool:
        nonlocal probes
        probes += 1
        return still_fails(mk(evs))

    n = 2
    while len(events) >= 1 and probes < max_probes:
        chunk = max(1, (len(events) + n - 1) // n)
        removed_any = False
        i = 0
        while i < len(events) and probes < max_probes:
            candidate = events[:i] + events[i + chunk :]
            if probe(candidate):
                events = candidate  # chunk was irrelevant; keep it gone
                removed_any = True
            else:
                i += chunk
        if removed_any:
            n = max(2, n - 1)  # coarsen back a step, re-scan
        elif chunk <= 1:
            break  # single-event granularity and nothing removable
        else:
            n = min(n * 2, max(1, len(events)))  # refine
    return mk(events)


def shrink_timing(
    schedule: Schedule,
    still_fails: Callable[[Schedule], bool],
    *,
    max_probes: int = 200,
    min_gap: float = 1e-4,
    precision: float = 1e-3,
) -> Schedule:
    """Shrink a failing schedule's *timing*: pull the surviving events as
    close together as the failure allows, exposing the tightest race.

    Runs after (or independently of) the event-subsequence ddmin
    (:func:`shrink_schedule`): the event list is held fixed and only the
    timestamps move.  Two phases, both probe-budgeted:

      1. **Global gap compression** — repeatedly try scaling every
         inter-event gap toward ``min_gap`` (halving the scale while the
         failure reproduces).  One probe per scale step collapses most of
         the slack at once.
      2. **Per-event left-pull** — walk the events in order and
         binary-search each event's earliest failing time in
         ``[prev + min_gap, current]`` down to ``precision`` of the gap.

    Chronological order is preserved by construction (an event never
    moves before its predecessor plus ``min_gap``).  The result is the
    last candidate for which ``still_fails`` returned True — always a
    reproducing schedule, never a guess.
    """
    events: List[Event] = list(schedule.events)
    if not events:
        return schedule

    def mk(times: List[float]) -> Schedule:
        return Schedule(
            schedule.name,
            schedule.seed,
            tuple(Event(t, e.fault) for t, e in zip(times, events)),
        )

    probes = 0

    def probe(times: List[float]) -> bool:
        nonlocal probes
        probes += 1
        return still_fails(mk(times))

    times = [e.at for e in events]

    def compressed(scale: float) -> List[float]:
        out = [times[0]]
        for i in range(1, len(times)):
            gap = max(min_gap, (times[i] - times[i - 1]) * scale)
            out.append(out[-1] + gap)
        return out

    # Phase 1: global gap compression (halve the scale while it fails).
    scale = 0.5
    while probes < max_probes and len(times) > 1:
        cand = compressed(scale)
        if cand == times:
            break
        if probe(cand):
            times = cand
            # keep halving from the *new* baseline
        else:
            break
        scale *= 0.5

    # Phase 2: per-event left-pull (binary search each event's floor).
    for i in range(len(times)):
        if probes >= max_probes:
            break
        floor = 0.0 if i == 0 else times[i - 1] + min_gap
        lo, hi = floor, times[i]
        if hi - lo <= precision * max(hi, 1.0):
            continue
        # Can it sit at the floor outright?
        cand = times[:i] + [lo] + times[i + 1 :]
        if probe(cand):
            times = cand
            continue
        # Earliest failing time is in (lo, hi]; bisect down to precision.
        while hi - lo > precision * max(hi, 1.0) and probes < max_probes:
            mid = (lo + hi) / 2.0
            cand = times[:i] + [mid] + times[i + 1 :]
            if probe(cand):
                hi = mid
                times = cand
            else:
                lo = mid
    return mk(times)


def shrink_failing_scenario(
    name: str,
    seed: int,
    *,
    transport: str = "sim",
    max_probes: int = 60,
    shrink_times: bool = False,
) -> Schedule:
    """Shrink a real failing (name, seed) run to a minimal schedule.

    Convenience wrapper: the predicate re-runs the scenario with each
    candidate subsequence on the deterministic simulator and asks whether
    any invariant still breaks.  ``shrink_times=True`` additionally runs
    the timing shrinker on the surviving events (tightest failing race)."""

    def still_fails(s: Schedule) -> bool:
        return not run_scenario(name, seed, transport=transport, schedule=s).safe

    shrunk = shrink_schedule(
        build_schedule(name, seed), still_fails, max_probes=max_probes
    )
    if shrink_times:
        shrunk = shrink_timing(shrunk, still_fails, max_probes=max_probes)
    return shrunk


# --------------------------------------------------------------------------
# Matrix driver (tests, soak CI, benchmarks)
# --------------------------------------------------------------------------
def run_matrix(
    names: Optional[Tuple[str, ...]] = None,
    seeds: Tuple[int, ...] = tuple(range(10)),
    *,
    transport: str = "sim",
    raise_on_violation: bool = True,
) -> List[ScenarioResult]:
    results = []
    for name in names or SCENARIO_NAMES:
        for seed in seeds:
            res = run_scenario(name, seed, transport=transport)
            if raise_on_violation:
                res.raise_if_unsafe()
            results.append(res)
    return results
