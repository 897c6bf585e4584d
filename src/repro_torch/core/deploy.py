"""Deployment harness: wire a full Matchmaker MultiPaxos system together.

Reproduces the paper's Section 8 topology: for a given ``f``, ``f+1``
proposers, a pool of ``2 x (2f+1)`` acceptors (reconfigurations draw random
``2f+1``-subsets from the pool), ``2f+1`` matchmakers (plus a standby pool
of ``2f+1`` more for matchmaker reconfigurations), and ``2f+1`` replicas.

The topology is described by a :class:`ClusterSpec`; ``spec.instantiate``
constructs the role nodes against *any* runtime transport (the
deterministic ``Simulator`` or ``net.AsyncTransport``), and the module
level ``build(...)`` keeps the historical one-call simulator entry point.

Also computes the paper's reporting statistics: sliding-window median /
IQR / stdev over latency and throughput samples (Tables 1 and 2).
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import messages as m
from .acceptor import Acceptor
from .client import Client, ShardRouter, shard_of_command
from .matchmaker import Matchmaker
from .mm_reconfig import MMReconfigCoordinator
from .oracle import Oracle
from .proposer import Options, Proposer
from .quorums import Configuration
from .replica import NoopSM, Replica, StateMachine
from .runtime import Transport
from .sim import NetworkConfig, Simulator


@dataclass
class Shard:
    """One shard of the sharded log plane: an unchanged Matchmaker Paxos
    instance (its own proposers + acceptor pool) behind the slot-ownership
    boundary (``core/log.py``).  Shard 0 of a 1-shard cluster is exactly
    the historical single-leader deployment.  Leader resolution lives in
    ``Deployment.shard_leader`` (and the routing closure in
    ``ClusterSpec.instantiate``), not here."""

    sid: int
    proposers: List[Proposer]
    acceptors: List[Acceptor]


@dataclass
class Deployment:
    # The runtime transport the nodes are registered on.  Named ``sim``
    # for continuity with the benchmark / test corpus; for asyncio builds
    # this holds an ``AsyncTransport`` (see the ``transport`` alias).
    sim: Any
    oracle: Oracle
    f: int
    proposers: List[Proposer]
    acceptors: List[Acceptor]
    matchmakers: List[Matchmaker]
    standby_matchmakers: List[Matchmaker]
    replicas: List[Replica]
    clients: List[Client]
    mm_coordinator: MMReconfigCoordinator
    config_seq: int = 0
    # The state-machine factory the replicas were built with; the nemesis
    # invariant checker replays the chosen log through a fresh instance to
    # verify client-observed results are linearizable.
    sm_factory: Callable[[], StateMachine] = NoopSM
    # Sharded log plane: the per-shard view of proposers/acceptors plus
    # the optional router node.  ``proposers``/``acceptors`` above remain
    # the flat (all-shard) lists the invariant checker iterates.
    shards: List[Shard] = field(default_factory=list)
    router: Optional[ShardRouter] = None
    num_shards: int = 1

    # ------------------------------------------------------------------
    @property
    def transport(self) -> Transport:
        return self.sim

    @property
    def leader(self) -> Proposer:
        # A crashed node may still carry a stale is_leader flag; clients
        # and scenario scripts must never be routed to a corpse.  With a
        # sharded log plane this is shard 0's leader.
        return self.shard_leader(0)

    def shard_proposers(self, shard: int = 0) -> List[Proposer]:
        if self.shards:
            return self.shards[shard].proposers
        return self.proposers

    def shard_leader(self, shard: int = 0) -> Proposer:
        group = self.shard_proposers(shard)
        for p in group:
            if p.is_leader and not p.failed:
                return p
        for p in group:
            if not p.failed:
                return p
        return group[0]

    def attach_nemesis(self, schedule, **kw):
        """Bind a nemesis schedule to this deployment (armed immediately)."""
        from .nemesis import Nemesis  # deploy is imported by nemesis users

        return Nemesis(self, schedule, **kw).arm()

    def fresh_config(self, acceptor_addrs: Sequence[str]) -> Configuration:
        self.config_seq += 1
        return Configuration.majority(self.config_seq, acceptor_addrs)

    def random_config(self, shard: int = 0) -> Configuration:
        """A random 2f+1-subset of the (shard's) acceptor pool (Sec 8.1)."""
        n = 2 * self.f + 1
        pool = self.shards[shard].acceptors if self.shards else self.acceptors
        addrs = self.sim.rng.sample([a.addr for a in pool], n)
        return self.fresh_config(sorted(addrs))

    def reconfigure_random(self, shard: int = 0) -> None:
        leader = self.shard_leader(shard)
        if not leader.is_leader or leader.round is None:
            return  # no stable leader yet (e.g. initial WAN Phase 1 pending)
        leader.reconfigure(self.random_config(shard))

    def reconfigure_matchmakers(self, new_addrs: Sequence[str]) -> None:
        if self.mm_coordinator.phase != "idle":
            return  # one at a time; benchmark schedules may overlap
        old = tuple(self.leader.matchmakers)
        if tuple(sorted(old)) == tuple(sorted(new_addrs)):
            return
        self.mm_coordinator.reconfigure(old, tuple(new_addrs))

    def start_clients(self) -> None:
        for c in self.clients:
            c.start()

    def stop_clients(self) -> None:
        for c in self.clients:
            c.stop()

    # -- Section 8 statistics -------------------------------------------
    def latencies(self, t0: float = 0.0, t1: float = float("inf")) -> List[float]:
        return [
            lat
            for c in self.clients
            for (t, lat) in c.latencies
            if t0 <= t < t1
        ]

    def throughput_samples(
        self, t0: float, t1: float, window: float = 1.0, stride: float = 0.1
    ) -> List[float]:
        """Sliding-window commands/sec, like the paper's Figure 9."""
        times = sorted(t for c in self.clients for (t, _) in c.latencies)
        samples = []
        t = t0 + window
        while t <= t1:
            lo, hi = t - window, t
            n = sum(1 for x in times if lo <= x < hi)
            samples.append(n / window)
            t += stride
        return samples

    @staticmethod
    def summary(xs: Sequence[float]) -> Dict[str, float]:
        if not xs:
            return {"median": 0.0, "iqr": 0.0, "stdev": 0.0, "n": 0}
        xs = sorted(xs)
        # True interquartile spread (Q3 - Q1).  Below four samples the
        # exclusive quartile estimate degenerates to the sample extremes,
        # so report 0.0 — never max - min mislabeled as "iqr".
        if len(xs) >= 4:
            q = statistics.quantiles(xs, n=4)
            iqr = q[2] - q[0]
        else:
            iqr = 0.0
        return {
            "median": statistics.median(xs),
            "iqr": iqr,
            "stdev": statistics.pstdev(xs) if len(xs) > 1 else 0.0,
            "n": len(xs),
        }

    def shard_telemetry(self) -> Dict[str, Any]:
        """Per-shard load/lag counters (the no-silent-imbalance surface):
        router forwards and coalesced relays per shard, plus each
        replica's backlog, per-shard chosen frontiers and execution-cursor
        lag.  Benchmarks record this next to the throughput curve."""
        tel: Dict[str, Any] = {"num_shards": self.num_shards}
        if self.router is not None:
            r = self.router
            tel["router"] = {
                "routed": r.routed,
                "routed_by_shard": dict(r.routed_by_shard),
                "relayed": r.relayed,
                "relayed_by_shard": dict(r.relayed_by_shard),
                "relay_batches": r.relay_batches,
                "relay_sliced": r.relay_sliced,
                "relay_decoded": r.relay_decoded,
                "unroutable": r.unroutable,
            }
        tel["replicas"] = {
            rep.addr: {
                "backlog": rep.elog.backlog(),
                "exec_watermark": rep.exec_watermark,
                "shard_frontiers": rep.elog.shard_frontiers(),
                "cursor_lag": rep.elog.cursor_lag(),
                "acks_sent": rep.acks_sent,
                "fill_requests": rep.fill_requests,
            }
            for rep in self.replicas
        }
        return tel

    def check_all(self) -> None:
        self.oracle.assert_safe()
        self.oracle.check_replicas(self.replicas)
        self.oracle.check_client_results(self.clients)


def make_transport(
    backend: str = "sim",
    *,
    seed: int = 0,
    net: Optional[NetworkConfig] = None,
) -> Transport:
    """Construct a runtime transport by name.

    ``"sim"`` — the deterministic discrete-event simulator;
    ``"async"`` — the in-process asyncio event loop (``net.AsyncTransport``);
    ``"tcp"`` — real sockets, one per node, binary wire frames
    (``tcp.TcpTransport``);
    ``"proc"`` — one OS process per node with a supervisor in the parent
    (``proc.ProcTransport``; use ``ClusterSpec.deploy("proc")`` to spawn
    the workers).  All four run the same role classes and the same
    nemesis fault schedules.
    """
    if backend == "sim":
        return Simulator(seed=seed, net=net)
    if backend == "async":
        from .net import AsyncTransport  # deploy is imported by net users

        return AsyncTransport(seed=seed, net=net)
    if backend == "tcp":
        from .tcp import TcpTransport

        return TcpTransport(seed=seed, net=net)
    if backend == "proc":
        from .proc import ProcTransport

        return ProcTransport(seed=seed, net=net)
    raise ValueError(f"unknown transport backend {backend!r}")


@dataclass
class ClusterSpec:
    """Declarative description of a paper-topology cluster.

    ``instantiate(transport)`` wires the role nodes onto any runtime
    transport; the same spec builds a deterministic simulation, an
    in-process asyncio deployment (``net.AsyncTransport``), or a real
    socket-per-node TCP deployment (``tcp.TcpTransport``) — see
    ``deploy(backend=...)``.  All knobs of the historical ``build(...)``
    entry point live here, plus the client-shape knobs used by the
    batching benchmark.
    """

    f: int = 1
    n_clients: int = 1
    options: Optional[Options] = None
    sm_factory: Callable[[], StateMachine] = NoopSM
    acceptor_pool: Optional[int] = None
    client_think_time: float = 0.0
    client_max_commands: Optional[int] = None
    client_retry_timeout: float = 0.5
    auto_elect_leader: bool = True
    # Sharded log plane: the log's slot space is stride-partitioned across
    # ``num_shards`` independent Matchmaker Paxos instances (each with its
    # own f+1 proposers and acceptor pool) that share the matchmaker set
    # and the replicas.  num_shards=1 is the historical deployment,
    # byte-for-byte.  ``route_via_router`` sends client traffic through
    # the ShardRouter node instead of routing client-side (with
    # num_shards=1 the router simply fronts the single leader).
    num_shards: int = 1
    route_via_router: bool = False
    # Client-side request coalescing at the router (ROADMAP batching
    # extension): the router merges *distinct clients'* commands bound
    # for the same shard leader into one Batch frame, so the leader's
    # ingress is one wire message per coalesced burst instead of one per
    # client.  Uses the deployment's batch policy; requires
    # route_via_router and an Options.batch_max > 1 to have any effect.
    router_coalesce: bool = False
    # Clients batch their own requests into SealedBatch envelopes (needs
    # Options.batch_max > 1).  Routed via the router this is the zero-copy
    # relay path: the router regroups the *encoded sub-frames* per shard
    # leader instead of decode->re-dispatch->re-encode.  Routed
    # client-side it simply coalesces the client's request egress.  Off
    # by default — existing scenarios are unchanged.
    client_coalesce: bool = False
    # Affinity-run routing (opt-in): consecutive commands from one client
    # map to the same shard in runs of this length, so a pipelined burst
    # fills whole wire batches to ONE leader instead of fragmenting
    # across every shard (see client.shard_of_command).  1 = historical
    # per-command round-robin.  Every cmd_id->shard mapping in the
    # deployment (client route closures, the router) uses this value.
    shard_affinity_run: int = 1

    # -- address plan ----------------------------------------------------
    def matchmaker_addrs(self) -> Tuple[str, ...]:
        return tuple(f"mm{i}" for i in range(2 * self.f + 1))

    def standby_matchmaker_addrs(self) -> Tuple[str, ...]:
        return tuple(f"mm{i}" for i in range(2 * self.f + 1, 2 * (2 * self.f + 1)))

    def acceptor_addrs(self) -> Tuple[str, ...]:
        n = self.acceptor_pool if self.acceptor_pool is not None else 2 * (2 * self.f + 1)
        return tuple(f"a{i}" for i in range(n))

    def replica_addrs(self) -> Tuple[str, ...]:
        return tuple(f"r{i}" for i in range(2 * self.f + 1))

    def proposer_addrs(self) -> Tuple[str, ...]:
        return tuple(f"p{i}" for i in range(self.f + 1))

    # Shard s > 0 gets its own namespaced proposer/acceptor addresses;
    # shard 0 keeps the historical names.
    def shard_proposer_addrs(self, shard: int) -> Tuple[str, ...]:
        if shard == 0:
            return self.proposer_addrs()
        return tuple(f"s{shard}p{i}" for i in range(self.f + 1))

    def shard_acceptor_addrs(self, shard: int) -> Tuple[str, ...]:
        if shard == 0:
            return self.acceptor_addrs()
        # Same pool size as shard 0, whatever acceptor_addrs() decides.
        return tuple(f"s{shard}a{i}" for i in range(len(self.acceptor_addrs())))

    def all_proposer_addrs(self) -> Tuple[str, ...]:
        return tuple(
            a
            for s in range(max(1, self.num_shards))
            for a in self.shard_proposer_addrs(s)
        )

    def all_acceptor_addrs(self) -> Tuple[str, ...]:
        return tuple(
            a
            for s in range(max(1, self.num_shards))
            for a in self.shard_acceptor_addrs(s)
        )

    def router_addr(self) -> str:
        return "router"

    def replica_ack_stride(self) -> int:
        """Sharded deployments coalesce replication-watermark acks (they
        fan out to every shard's proposers); unsharded keeps
        ack-per-progression.  Shared by ``instantiate`` and the proc
        plane's ``build_worker_node`` so the two planes can't drift."""
        return 16 if max(1, self.num_shards) > 1 else 1

    # -- construction ----------------------------------------------------
    def instantiate(self, transport: Transport) -> Deployment:
        """Construct and register every role node on ``transport``."""
        f = self.f
        S = max(1, self.num_shards)
        oracle = Oracle()
        opts = self.options or Options()
        batch = opts.batch_policy()

        mm_addrs = self.matchmaker_addrs()
        standby_addrs = self.standby_matchmaker_addrs()
        rep_addrs = self.replica_addrs()
        shard_acc_addrs = [self.shard_acceptor_addrs(s) for s in range(S)]
        shard_prop_addrs = [self.shard_proposer_addrs(s) for s in range(S)]
        all_prop_addrs = tuple(a for sp in shard_prop_addrs for a in sp)

        matchmakers = [Matchmaker(a) for a in mm_addrs]
        standby = [Matchmaker(a, enabled=False) for a in standby_addrs]
        acceptors_by_shard = [
            [Acceptor(a, batch=batch) for a in addrs] for addrs in shard_acc_addrs
        ]
        acceptors = [a for group in acceptors_by_shard for a in group]
        replicas = [
            Replica(
                a,
                self.sm_factory,
                leader_addrs=all_prop_addrs,
                peers=rep_addrs,
                batch=batch,
                num_shards=S,
                ack_stride=self.replica_ack_stride(),
                # Per-shard proposer groups: replication acks rotate one
                # group per stride and fill requests target the shard
                # that owns the execution hole (O(1) instead of O(S)).
                leader_groups=tuple(shard_prop_addrs),
            )
            for a in rep_addrs
        ]
        proposers_by_shard = [
            [
                Proposer(
                    shard_prop_addrs[s][i],
                    i,
                    matchmakers=mm_addrs,
                    replicas=rep_addrs,
                    proposers=shard_prop_addrs[s],
                    oracle=oracle,
                    options=opts,
                    f=f,
                    shard=s,
                    num_shards=S,
                )
                for i in range(f + 1)
            ]
            for s in range(S)
        ]
        proposers = [p for group in proposers_by_shard for p in group]

        def on_mm_complete(new_set: Tuple[str, ...]) -> None:
            for p in proposers:
                p.set_matchmakers(new_set)

        mm_coord = MMReconfigCoordinator(
            "mmcoord", 99, f=f, on_complete=on_mm_complete
        )

        def shard_leader_addr(s: int) -> Optional[str]:
            group = proposers_by_shard[s]
            for p in group:
                if p.is_leader and not p.failed:
                    return p.addr
            # Fall back to whoever the live proposers believe leads.
            for p in group:
                if p.leader_addr and not p.failed:
                    return p.leader_addr
            return shard_prop_addrs[s][0]

        def current_leader() -> Optional[str]:
            return shard_leader_addr(0)

        router: Optional[ShardRouter] = None
        if S > 1 or self.route_via_router:
            router = ShardRouter(
                self.router_addr(),
                [lambda s=s: shard_leader_addr(s) for s in range(S)],
                batch=batch if self.router_coalesce else None,
                affinity_run=self.shard_affinity_run,
            )

        run = self.shard_affinity_run
        if self.route_via_router:
            leader_provider = lambda: self.router_addr()  # noqa: E731
            route = None
        elif S > 1:
            leader_provider = current_leader
            route = lambda cid: shard_leader_addr(shard_of_command(cid, S, run))  # noqa: E731
        else:
            leader_provider = current_leader
            route = None

        client_batch = (
            opts.batch_policy(sealed=True) if self.client_coalesce else None
        )
        clients = [
            Client(
                f"c{i}",
                leader_provider,
                think_time=self.client_think_time,
                max_commands=self.client_max_commands,
                retry_timeout=self.client_retry_timeout,
                route=route,
                batch=client_batch,
            )
            for i in range(self.n_clients)
        ]

        nodes = [*matchmakers, *standby, *acceptors, *replicas, *proposers, mm_coord]
        if router is not None:
            nodes.append(router)
        nodes.extend(clients)
        for node in nodes:
            transport.register(node)

        dep = Deployment(
            sim=transport,
            oracle=oracle,
            f=f,
            proposers=proposers,
            acceptors=acceptors,
            matchmakers=matchmakers,
            standby_matchmakers=standby,
            replicas=replicas,
            clients=clients,
            mm_coordinator=mm_coord,
            sm_factory=self.sm_factory,
            shards=[
                Shard(s, proposers_by_shard[s], acceptors_by_shard[s])
                for s in range(S)
            ],
            router=router,
            num_shards=S,
        )
        if self.auto_elect_leader:
            # Election only emits effects, so it is transport-agnostic;
            # on AsyncTransport the effects replay when run() starts.
            # Every shard elects its proposer 0 on its own acceptor pool.
            for sh in dep.shards:
                sh.proposers[0].become_leader(
                    dep.fresh_config([a.addr for a in sh.acceptors[: 2 * f + 1]])
                )
        return dep

    def deploy(
        self,
        backend: str = "sim",
        *,
        seed: int = 0,
        net: Optional[NetworkConfig] = None,
    ) -> Tuple[Transport, Deployment]:
        """One-call backend-parameterized construction: build the named
        transport (``"sim"`` / ``"async"`` / ``"tcp"`` / ``"proc"``) and
        instantiate this spec on it.  Returns ``(transport, deployment)``
        — drive the transport (``run_for`` / ``run``) yourself.  The proc
        backend spawns one OS process per node (clients stay in this
        process); tear it down with ``deployment.shutdown()``."""
        if backend == "proc":
            from .proc import deploy_proc

            return deploy_proc(self, seed=seed, net=net)
        transport = make_transport(backend, seed=seed, net=net)
        return transport, self.instantiate(transport)


def build(
    *,
    f: int = 1,
    n_clients: int = 1,
    seed: int = 0,
    options: Optional[Options] = None,
    net: Optional[NetworkConfig] = None,
    sm_factory: Callable[[], StateMachine] = NoopSM,
    acceptor_pool: Optional[int] = None,
    client_think_time: float = 0.0,
    auto_elect_leader: bool = True,
) -> Deployment:
    """Build the paper's deployment on the deterministic simulator and
    elect proposer 0 the leader (the historical one-call entry point)."""
    spec = ClusterSpec(
        f=f,
        n_clients=n_clients,
        options=options,
        sm_factory=sm_factory,
        acceptor_pool=acceptor_pool,
        client_think_time=client_think_time,
        auto_elect_leader=auto_elect_leader,
    )
    sim = Simulator(seed=seed, net=net)
    dep = spec.instantiate(sim)  # elects proposer 0 unless disabled
    if spec.auto_elect_leader:
        sim.run_for(0.01)  # let matchmaking + phase 1 settle
    return dep
