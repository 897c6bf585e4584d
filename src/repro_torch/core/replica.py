"""State machine replicas (Section 4.1 / 5.3).

Replicas insert chosen commands into their logs, execute them in prefix
order, and reply to clients.  For garbage collection Scenario 3, the paper
deploys ``2f+1`` replicas and requires the chosen prefix to be stored on at
least ``f+1`` of them before old configurations are retired — replicas
therefore ack their persisted watermark back to the leader.

The state machine is pluggable; the paper's evaluation uses a one-byte
no-op state machine, and the training framework plugs in the cluster
ledger (src/repro/coord).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from . import messages as m
from .log import ExecutionLog, shard_of_slot
from .runtime import BatchPolicy, on
from .sim import Address, Node


class StateMachine:
    def apply(self, op: Any) -> Any:
        raise NotImplementedError


class NoopSM(StateMachine):
    """The paper's evaluation state machine: every command is a no-op."""

    def apply(self, op: Any) -> Any:
        return "ok"


class KVStoreSM(StateMachine):
    """A tiny KV store, used by tests to check replica-state convergence."""

    def __init__(self):
        self.store: Dict[str, Any] = {}

    def apply(self, op: Any) -> Any:
        kind = op[0]
        if kind == "set":
            _, k, v = op
            self.store[k] = v
            return ("ok", k)
        if kind == "get":
            return self.store.get(op[1])
        return "ok"


class Replica(Node):
    """Executes the chosen log in slot order.

    Under the sharded log plane (core/log.py) chosen values arrive as
    interleaved per-shard streams — each shard's leader broadcasts Chosen
    for its stride-owned slots independently, so the log fills with
    per-shard holes (a dead shard's slots stay open until its successor
    noop-fills them).  Execution is pipelined over those streams: entries
    buffer per shard in the :class:`ExecutionLog` and execute the moment
    the contiguous prefix reaches them, which keeps the output order
    invariant under ANY interleaving of the shard streams.
    """

    def __init__(
        self,
        addr: Address,
        sm_factory: Callable[[], StateMachine] = NoopSM,
        *,
        leader_addrs: Tuple[Address, ...] = (),
        peers: Tuple[Address, ...] = (),
        batch: Optional[BatchPolicy] = None,
        num_shards: int = 1,
        fill_interval: float = 0.01,
        ack_stride: int = 1,
        leader_groups: Tuple[Tuple[Address, ...], ...] = (),
    ):
        super().__init__(addr, batch=batch)
        self.sm_factory = sm_factory
        self.sm = sm_factory()
        self.elog = ExecutionLog(num_shards=num_shards)
        self.leader_addrs = leader_addrs
        # Peer replicas, for the disk-loss re-sync path (RecoverA to the
        # peers; any one live peer's RecoverB restores the whole prefix).
        self.peers = tuple(p for p in peers if p != addr)
        # Replication-watermark acks used to fan out to EVERY shard's
        # proposers — O(num_shards) egress per ack, the replicas' dominant
        # cost at 4+ shards.  Acks coalesce to every ``ack_stride``
        # executed slots (stride 1 = the historical ack-per-progression)
        # and, when ``leader_groups`` supplies the per-shard proposer
        # groups, each stride's ack *rotates* to one group — O(1) egress
        # per stride.  Safe because the watermark is monotone and
        # AckTracker max-merges: a leader acting on a stale (lower)
        # watermark only GCs later, never earlier.  The fill timer
        # re-broadcasts the watermark to every group at quiescence, so no
        # leader lags more than one fill interval.
        self.ack_stride = max(1, ack_stride)
        self.leader_groups = tuple(tuple(g) for g in leader_groups) or (
            (tuple(leader_addrs),) if leader_addrs else ()
        )
        # Stagger the rotation start per replica so the leader groups
        # hear from *different* replicas each stride (GC wants f+1
        # replica acks per leader to keep advancing between broadcasts).
        self._ack_rr = (
            sum(addr.encode()) % len(self.leader_groups)
            if self.leader_groups
            else 0
        )
        self._acked_all_at = 0  # exec watermark last broadcast to all groups
        self._last_acked = 0
        self.executed: Dict[Tuple[str, int], Any] = {}  # cmd_id -> result (dedup)
        # Sharded log plane: an idle shard leaves holes that block the
        # contiguous execution prefix; if the watermark is stuck with
        # chosen entries queued behind it, ask the owning shard leader to
        # noop-fill (Mencius-style skip).  Only armed when sharded.
        self.fill_interval = fill_interval
        self._fill_stuck_at = -1
        self._fill_targeted = False
        # Disk-loss fault model (nemesis.DiskLoss): set while this
        # replica's persisted state is gone and a re-sync is owed.
        self._disk_lost = False
        # True from the re-sync RecoverA broadcast until the first peer
        # RecoverB lands; a retry timer re-broadcasts while set, so the
        # one request is not a single point of loss on a faulty network.
        self._resync_pending = False
        # telemetry
        self.executions = 0
        self.fill_requests = 0
        self.acks_sent = 0
        self.disk_losses = 0
        self.resyncs = 0

    def on_start(self) -> None:
        if self.elog.num_shards > 1 and self.leader_addrs:
            self.set_timer(self.fill_interval, self._fill_tick)

    def on_restart(self) -> None:
        self.on_start()
        if self._disk_lost:
            self._resync()
        elif self._resync_pending:
            self._arm_resync_retry()  # crash interrupted a re-sync: resume

    # -- durability (proc plane) -------------------------------------------
    # The replica's log, execution watermark and at-most-once dedup table
    # are the f+1-durability substrate of GC Scenario 3: they are
    # persisted before any ReplicaAck or ClientReply leaves the process
    # (the proc worker host enforces the ordering).  The state machine
    # itself is NOT serialized — execution is deterministic and
    # slot-ordered, so a restarted process replays the executed prefix
    # through a fresh instance (without re-sending client replies).
    def persistent_state(self) -> Dict[str, Any]:
        return {
            "entries": dict(self.elog.entries),
            "watermark": self.elog.watermark,
            "executed": dict(self.executed),
            "last_acked": self._last_acked,
        }

    def load_persistent_state(self, state: Dict[str, Any]) -> None:
        self.elog = ExecutionLog(num_shards=self.elog.num_shards)
        for slot, value in state["entries"].items():
            self.elog.insert(slot, value)
        self.elog.watermark = state["watermark"]
        self.executed = dict(state["executed"])
        self._last_acked = state["last_acked"]
        self._acked_all_at = 0  # force a full ack broadcast post-recovery
        # Rebuild the SM by replaying the executed prefix with the same
        # at-most-once rule live execution used; no messages are emitted.
        self.sm = self.sm_factory()
        seen: set = set()
        for slot in range(self.elog.watermark):
            value = self.elog.entries.get(slot)
            if isinstance(value, m.Command) and value.cmd_id not in seen:
                seen.add(value.cmd_id)
                self.sm.apply(value.op)
        self._disk_lost = False
        self._resync_pending = False

    # -- disk-loss fault model ---------------------------------------------
    def lose_disk(self) -> None:
        """Wipe this replica's persisted state (nemesis.DiskLoss): the
        chosen log, the executed-prefix state machine and the at-most-once
        dedup table all go.  A crashed replica re-syncs on restart; a live
        one re-syncs immediately.  Replaying the prefix from a peer
        reproduces identical results (execution is deterministic and
        slot-ordered), so re-sent client replies stay linearizable."""
        self.disk_losses += 1
        self.elog = ExecutionLog(num_shards=self.elog.num_shards)
        self.sm = self.sm_factory()
        self.executed.clear()
        self._last_acked = 0
        self._acked_all_at = 0
        self._fill_stuck_at = -1
        self._fill_targeted = False
        self._disk_lost = True
        if not self.failed:
            self._resync()

    def _resync(self) -> None:
        """Refill the wiped log from the peer replicas.  New Chosen
        broadcasts keep landing in parallel; the contiguous-prefix
        execution rule makes the interleaving safe.  The request retries
        on a timer until a peer answers — drops, storms and partitions
        must delay a re-sync, never wedge it."""
        self._disk_lost = False
        self.resyncs += 1
        if not self.peers:
            return
        self._resync_pending = True
        self.broadcast(self.peers, m.RecoverA())
        self._arm_resync_retry()

    def _arm_resync_retry(self) -> None:
        def retry() -> None:
            if self._resync_pending and not self.failed:
                self.broadcast(self.peers, m.RecoverA())
                self._arm_resync_retry()

        self.set_timer(self.fill_interval, retry)

    @on(m.RecoverB)
    def _on_recover_b(self, src: Address, msg: m.RecoverB) -> None:
        """A peer's chosen prefix (disk-loss re-sync answer)."""
        self._resync_pending = False
        progressed = False
        for slot, value in msg.entries:
            prev = self.elog.insert(slot, value)
            if prev is not None:
                assert _value_eq(prev, value), (
                    f"SAFETY VIOLATION at replica {self.addr}: re-sync slot "
                    f"{slot} has both {prev} and {value}"
                )
        for _slot, value in self.elog.drain_executable():
            self._execute(value)
            progressed = True
        if progressed and self.exec_watermark - self._last_acked >= self.ack_stride:
            self._send_acks()

    def _fill_tick(self) -> None:
        if self.exec_watermark != self._acked_all_at:
            # Flush the partial ack stride AND re-sync every leader group
            # the rotation skipped since the last tick (quiescence
            # convergence for GC Scenario 3).
            self._send_acks(everyone=True)
        if self.elog.backlog() > 0:
            if self.elog.watermark == self._fill_stuck_at:
                self.fill_requests += 1
                if self._fill_targeted:
                    # A targeted request already failed to unstick us
                    # (that shard's leader may be down): escalate to
                    # every shard so one round-trip closes every hole
                    # below the frontier.
                    for p in self.leader_addrs:
                        self.send(p, m.FillRequest(slot=self.elog.max_slot))
                    self._fill_targeted = False
                else:
                    # The execution hole at the watermark belongs to
                    # exactly one shard; ask only its proposer group
                    # (O(1) fill traffic instead of O(num_shards)).
                    owner = shard_of_slot(self.elog.watermark, self.elog.num_shards)
                    for p in self._group_for(owner):
                        self.send(p, m.FillRequest(slot=self.elog.max_slot))
                    self._fill_targeted = True
            else:
                self._fill_targeted = False  # progressed since last tick
            self._fill_stuck_at = self.elog.watermark
        else:
            self._fill_stuck_at = -1
            self._fill_targeted = False
        self.set_timer(self.fill_interval, self._fill_tick)

    def _group_for(self, shard: int) -> Tuple[Address, ...]:
        if len(self.leader_groups) == self.elog.num_shards:
            return self.leader_groups[shard]
        return tuple(self.leader_addrs)

    # Historical views: ``log`` is the slot -> value dict, ``exec_watermark``
    # the executed-prefix bound (tests, invariant checker, recovery).
    @property
    def log(self) -> Dict[int, Any]:
        return self.elog.entries

    @property
    def exec_watermark(self) -> int:
        return self.elog.watermark

    def shard_frontiers(self) -> Dict[int, int]:
        """Per-shard chosen frontier (pipelined-execution telemetry)."""
        return self.elog.shard_frontiers()

    @on(m.RecoverA)
    def _on_recover_a(self, src: Address, msg: m.RecoverA) -> None:
        entries = tuple(sorted(self.log.items()))
        self.send(src, m.RecoverB(watermark=self.exec_watermark, entries=entries))

    @on(m.Chosen)
    def _on_chosen(self, src: Address, msg: m.Chosen) -> None:
        prev = self.elog.insert(msg.slot, msg.value)
        if prev is not None:
            assert _value_eq(prev, msg.value), (
                f"SAFETY VIOLATION at replica {self.addr}: slot {msg.slot} "
                f"chose both {prev} and {msg.value}"
            )
        progressed = False
        for _slot, value in self.elog.drain_executable():
            self._execute(value)
            progressed = True
        if progressed and self.exec_watermark - self._last_acked >= self.ack_stride:
            self._send_acks()

    def _send_acks(self, everyone: bool = False) -> None:
        # Scenario 3: tell leaders how much of the prefix we hold.  On
        # the hot path each stride's ack rotates to ONE shard's proposer
        # group (O(1) egress); ``everyone=True`` (the fill-tick flush and
        # single-group deployments) broadcasts to every group so all
        # leaders converge within one fill interval.
        self._last_acked = self.exec_watermark
        self.acks_sent += 1
        groups = self.leader_groups
        if everyone or len(groups) <= 1:
            self._acked_all_at = self.exec_watermark
            for p in self.leader_addrs:
                self.send(p, m.ReplicaAck(watermark=self.exec_watermark))
            return
        group = groups[self._ack_rr % len(groups)]
        self._ack_rr += 1
        for p in group:
            self.send(p, m.ReplicaAck(watermark=self.exec_watermark))

    def _execute(self, value: Any) -> None:
        self.executions += 1
        if not isinstance(value, m.Command):
            return  # Noop holes, ConfigChange entries, etc. have no effect
        if value.cmd_id in self.executed:
            return  # at-most-once
        result = self.sm.apply(value.op)
        self.executed[value.cmd_id] = result
        client = value.cmd_id[0]
        self.send(client, m.ClientReply(cmd_id=value.cmd_id, result=result))


def _value_eq(a: Any, b: Any) -> bool:
    if isinstance(a, m.Noop) and isinstance(b, m.Noop):
        return True
    return a == b
