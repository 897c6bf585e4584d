"""The cluster control plane: Matchmaker MultiPaxos as the membership,
ordering and durability authority of the training framework.

This is the paper -> framework bridge (DESIGN.md Section 2):

  * The replicated state machine is the **cluster ledger** (LedgerSM): a
    totally ordered log of ``ReconfigCommand`` / ``StepRecord`` /
    ``CheckpointCommit`` entries.
  * A *membership epoch* (which pods participate in training) maps to a
    consensus **round**: a planned membership change is the stable
    leader bumping ``s`` (Phase-1 bypass applies -> zero-stall); a
    coordinator failover bumps ``r``.
  * The acceptor configuration for epoch ``e`` is hosted *on the pods of
    epoch e*: reconfiguring the training cluster and reconfiguring the
    consensus group are the same operation, which is exactly the
    scenario Matchmaker Paxos was built for (elastic systems,
    Section 1 of the paper).
  * A checkpoint is **durable** once its ``CheckpointCommit`` is chosen
    and the prefix is on f+1 replicas — GC Scenario 3 — after which old
    pods may be released (the paper's "shut down old configurations").

The protocol runs on the deterministic simulator (core/sim.py) — in a
real deployment the same state machines run over TCP; nothing in this
file assumes simulated time.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import messages as m
from repro_torch.core.acceptor import Acceptor
from repro_torch.core.deploy import ClusterSpec, Deployment
from repro_torch.core.oracle import Oracle
from repro_torch.core.proposer import Options, Proposer
from repro_torch.core.quorums import Configuration
from repro_torch.core.replica import Replica, StateMachine
from repro_torch.core.sim import NetworkConfig, Simulator


# --------------------------------------------------------------------------
# Ledger commands + materialized state
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ReconfigCommand:
    epoch: int
    pods: Tuple[str, ...]

    def __repr__(self):
        return f"Reconfig(e{self.epoch}, {list(self.pods)})"


@dataclass(frozen=True)
class StepRecord:
    step: int
    epoch: int
    metrics_digest: str = ""


@dataclass(frozen=True)
class CheckpointCommit:
    step: int
    manifest_digest: str


@dataclass(frozen=True)
class QuorumRecord:
    """Which pods' gradients were in the quorum for a step range —
    the data-plane thriftiness certificate."""

    step: int
    pod_mask: Tuple[int, ...]


class LedgerSM(StateMachine):
    """Materialized view of the cluster ledger."""

    def __init__(self):
        self.epoch = -1  # no membership committed yet
        self.pods: Tuple[str, ...] = ()
        self.last_step = -1
        self.last_step_epoch = 0
        self.durable_step = -1
        self.durable_digest = ""
        self.history: List[Any] = []

    def apply(self, op: Any) -> Any:
        self.history.append(op)
        if isinstance(op, ReconfigCommand):
            if op.epoch > self.epoch:
                self.epoch, self.pods = op.epoch, op.pods
            return ("epoch", self.epoch)
        if isinstance(op, StepRecord):
            if op.step > self.last_step:
                self.last_step, self.last_step_epoch = op.step, op.epoch
            return ("step", self.last_step)
        if isinstance(op, CheckpointCommit):
            if op.step > self.durable_step:
                self.durable_step = op.step
                self.durable_digest = op.manifest_digest
            return ("durable", self.durable_step)
        if isinstance(op, QuorumRecord):
            return ("quorum", op.step)
        return ("ok", None)


# --------------------------------------------------------------------------
# Cluster controller
# --------------------------------------------------------------------------
@dataclass
class PodInfo:
    name: str
    acceptor_addrs: Tuple[str, ...]  # acceptors hosted on this pod

    def shard_slice(self, shard: int, group: int) -> Tuple[str, ...]:
        """The ``group``-sized slice of this pod's acceptors dedicated to
        one proposer shard (each shard needs its own acceptor group)."""
        return self.acceptor_addrs[shard * group : (shard + 1) * group]


class ClusterController:
    """Drives the consensus deployment for the elastic trainer.

    Acceptors are grouped by pod: epoch e's configuration draws its
    2f+1 acceptors from the pods of epoch e, so membership changes and
    consensus reconfigurations coincide.
    """

    def __init__(
        self,
        pods: Sequence[str],
        *,
        f: int = 1,
        seed: int = 0,
        net: Optional[NetworkConfig] = None,
        options: Optional[Options] = None,
        num_shards: int = 1,
    ):
        self.f = f
        # Sharded log plane: the ledger's slot space is stride-partitioned
        # across ``num_shards`` proposer shards; each pod hosts one
        # 2f+1-acceptor group per shard so membership changes still map
        # 1:1 onto per-shard consensus reconfigurations.
        self.num_shards = max(1, num_shards)
        # The ledger cluster is described declaratively and instantiated on
        # the deterministic simulator transport; a real deployment hands
        # the same spec an AsyncTransport (or a future TCP transport).
        self.spec = ClusterSpec(
            f=f,
            n_clients=0,
            options=options,
            sm_factory=LedgerSM,
            acceptor_pool=0,
            auto_elect_leader=False,
            num_shards=self.num_shards,
        )
        self.sim = Simulator(seed=seed, net=net)
        self.dep: Deployment = self.spec.instantiate(self.sim)
        self.pods: Dict[str, PodInfo] = {}
        self._acc_seq = itertools.count()
        self._cmd_seq = itertools.count(1)
        self._pending: Dict[Tuple[str, int], Any] = {}
        self.epoch = 0
        self.epoch_pods: Tuple[str, ...] = tuple(pods)
        # Register the initial pods' acceptors and elect every shard's
        # leader on its slice of them.
        for p in pods:
            self.add_pod(p)
        for s, sh in enumerate(self.dep.shards):
            sh.proposers[0].become_leader(self._config_for(self.epoch_pods, shard=s))
        self.sim.run_for(0.05)
        self.commit(ReconfigCommand(epoch=0, pods=self.epoch_pods))

    # -- failure detection --------------------------------------------------
    def attach_detector(
        self,
        spares: Sequence[str] = (),
        *,
        ping_interval: float = 0.02,
        suspect_after: float = 0.08,
        confirm_misses: int = 2,
    ):
        """Wire a heartbeat FailureDetector over every pod's acceptors
        AND every proposer shard's leaders.

        A *confirmed* suspicion (``confirm_misses`` consecutive silent
        probe rounds — transport-level crash evidence, not a synthetic
        flag) of a pod replaces it with the next spare and drives a real
        ``reconfigure``.  A confirmed suspicion of a shard's *leader*
        promotes that shard's follower (full Phase-1 takeover on the
        shard's own acceptor group) — the other shards are untouched:
        their leaders, rounds and configurations never change.  Returns
        the detector; history is on ``detector.suspected`` / the
        controller's ``failover_log``.
        """
        from repro_torch.coord.failure import FailureDetector

        self._spares: List[str] = list(spares)
        self.failover_log: List[Dict[str, Any]] = []

        def on_suspect_leader(key: str) -> None:
            _, s_str, addr = key.split(":", 2)
            s = int(s_str)
            group = self.dep.shard_proposers(s)
            victim = next((p for p in group if p.addr == addr), None)
            if victim is None or not victim.is_leader:
                return  # a silent follower needs no failover
            successor = next(
                (p for p in group if p.addr != addr and not p.failed), None
            )
            if successor is None:
                return
            successor.become_leader(self._config_for(self.epoch_pods, shard=s))
            self.failover_log.append(
                {
                    "suspected": addr,
                    "shard": s,
                    "action": "shard_takeover",
                    "new_leader": successor.addr,
                }
            )

        def on_suspect(key: str) -> None:
            if key.startswith("proposer:"):
                on_suspect_leader(key)
                return
            pod = key
            if pod not in self.epoch_pods:
                return
            replacement = self._spares.pop(0) if self._spares else None
            new_pods = [
                p for p in self.epoch_pods if p != pod
            ] + ([replacement] if replacement else [])
            if len(new_pods) == 0:
                return
            telemetry = self.reconfigure(new_pods)
            self.detector.unwatch(pod)
            if replacement is not None:
                # Keep watching the whole live membership: the promoted
                # spare must be probed too, or the cluster is blind to any
                # failure after the first.
                self.detector.watch(
                    replacement, self.pods[replacement].acceptor_addrs
                )
            self.failover_log.append(
                {"suspected": pod, "replacement": replacement, **telemetry}
            )

        targets: Dict[str, Any] = {
            p: info.acceptor_addrs for p, info in self.pods.items()
        }
        for s, sh in enumerate(self.dep.shards):
            for p in sh.proposers:
                targets[f"proposer:{s}:{p.addr}"] = (p.addr,)

        self.detector = FailureDetector(
            "detector",
            targets,
            ping_interval=ping_interval,
            suspect_after=suspect_after,
            confirm_misses=confirm_misses,
            on_suspect=on_suspect,
        )
        self.sim.register(self.detector)
        return self.detector

    # -- pod / acceptor management ----------------------------------------
    def add_pod(self, name: str) -> PodInfo:
        if name in self.pods:
            return self.pods[name]
        # Pod-hosted acceptors get the same hot-path batch policy as the
        # spec-built roles, so consensus_options batching covers the
        # acceptor->proposer Phase2B leg too.  One 2f+1 group per shard.
        batch = (self.spec.options or Options()).batch_policy()
        addrs = []
        for _ in range(self.num_shards * (2 * self.f + 1)):
            a = Acceptor(f"{name}/acc{next(self._acc_seq)}", batch=batch)
            self.sim.register(a)
            self.dep.acceptors.append(a)
            addrs.append(a.addr)
        info = PodInfo(name=name, acceptor_addrs=tuple(addrs))
        self.pods[name] = info
        return info

    def fail_pod(self, name: str) -> None:
        for a in self.pods[name].acceptor_addrs:
            self.sim.fail(a)

    def _config_for(self, pods: Sequence[str], shard: int = 0) -> Configuration:
        """2f+1 acceptors spread across the pod set (one per pod,
        wrapping), drawn from each pod's slice for ``shard``."""
        group = 2 * self.f + 1
        addrs = []
        pod_list = [self.pods[p] for p in pods]
        i = 0
        while len(addrs) < group:
            pod = pod_list[i % len(pod_list)]
            idx = i // len(pod_list)
            pool = pod.shard_slice(shard, group)
            addrs.append(pool[idx % len(pool)])
            i += 1
        return self.dep.fresh_config(addrs)

    # -- ledger operations --------------------------------------------------
    def commit(self, op: Any, timeout: float = 1.0) -> int:
        """Propose ``op`` and run the sim until it is chosen; returns slot."""
        cmd = m.Command(cmd_id=("ctrl", next(self._cmd_seq)), op=op)
        from repro_torch.core.client import shard_of_command

        leader = self.dep.shard_leader(shard_of_command(cmd.cmd_id, self.num_shards))
        before = set(leader.chosen_values)
        leader.on_message("ctrl", m.ClientRequest(command=cmd))
        deadline = self.sim.now + timeout
        while self.sim.now < deadline:
            self.sim.run_for(0.001)
            for slot, v in leader.chosen_values.items():
                if slot not in before and isinstance(v, m.Command) and v.cmd_id == cmd.cmd_id:
                    return slot
        raise TimeoutError(f"ledger commit of {op!r} timed out")

    def reconfigure(self, new_pods: Sequence[str]) -> Dict[str, float]:
        """Membership change: one Matchmaker reconfiguration + one ledger
        entry.  Returns timing telemetry (the paper's 'few ms' claim)."""
        for p in new_pods:
            self.add_pod(p)
        t0 = self.sim.now
        n_reconfigs_before = len(self.dep.oracle.reconfig_durations)
        # Every shard swaps onto the new pods' acceptor slices — one
        # membership change is num_shards independent consensus
        # reconfigurations against the shared matchmaker set.  A shard
        # caught without a stable leader (mid-takeover, leader crashed)
        # must not be silently left on the old membership: promote its
        # live proposer straight onto the new configuration instead
        # (takeover = full Phase 1 against the new acceptor set).
        n_started = 0
        skipped = []
        for s in range(self.num_shards):
            leader = self.dep.shard_leader(s)
            cfg = self._config_for(new_pods, shard=s)
            if leader.is_leader and leader.round is not None:
                leader.reconfigure(cfg)
                n_started += 1
            elif not leader.failed:
                leader.become_leader(cfg)
                n_started += 1
            else:
                skipped.append(s)  # every proposer of the shard is down
        # The new configuration is active right after the Matchmaking
        # phase (Optimization 2 keeps commands flowing meanwhile).
        deadline = self.sim.now + 1.0
        while (
            len(self.dep.oracle.reconfig_durations) < n_reconfigs_before + n_started
            and self.sim.now < deadline
        ):
            self.sim.run_for(0.001)
        t_active = self.sim.now
        self.epoch += 1
        self.epoch_pods = tuple(new_pods)
        self.commit(ReconfigCommand(epoch=self.epoch, pods=self.epoch_pods))
        return {
            "reconfig_started": t0,
            "config_active": t_active,
            "activation_ms": (t_active - t0) * 1e3,
            "shards_reconfigured": float(n_started),
            "shards_skipped": float(len(skipped)),
        }

    def commit_step(self, step: int, digest: str = "") -> None:
        self.commit(StepRecord(step=step, epoch=self.epoch, metrics_digest=digest))

    def commit_checkpoint(self, step: int, manifest_digest: str) -> None:
        """GC Scenario 3: once chosen + replicated, pre-checkpoint ledger
        state is collectable and pre-epoch pods releasable."""
        self.commit(CheckpointCommit(step=step, manifest_digest=manifest_digest))

    def commit_quorum(self, step: int, pod_mask: Sequence[int]) -> None:
        self.commit(QuorumRecord(step=step, pod_mask=tuple(pod_mask)))

    # -- views ---------------------------------------------------------------
    def ledger(self) -> LedgerSM:
        return self.dep.replicas[0].sm  # type: ignore[return-value]

    def membership(self) -> Tuple[int, Tuple[str, ...]]:
        sm = self.ledger()
        return sm.epoch, sm.pods

    def durable_step(self) -> int:
        return self.ledger().durable_step

    def check_safety(self) -> None:
        self.dep.check_all()

    def retired_config_count(self) -> int:
        return len(self.dep.leader.retired_config_ids)
