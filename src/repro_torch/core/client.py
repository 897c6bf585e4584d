"""Closed-loop workload clients (Section 8 methodology) + shard routing.

Every client repeatedly proposes a state machine command, waits for the
response, and immediately proposes another.  Latency samples are recorded
with their (virtual) timestamps so benchmarks can compute the paper's
sliding-window medians / IQRs / standard deviations.

Sharded log plane routing: a command belongs to exactly one proposer
shard (``shard_of_command``, a deterministic PYTHONHASHSEED-independent
hash of its cmd_id).  Clients can route *client-side* (``route=`` hands
every command straight to its shard leader, zero extra hops) or through
the :class:`ShardRouter` role (one forwarding node, the deployment shape
for clients that must not know the shard map).
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import messages as m
from .runtime import on
from .sim import Address, Node


def shard_of_command(
    cmd_id: Tuple[str, int], num_shards: int, run: int = 1
) -> int:
    """Deterministic shard assignment for a command.

    Stable across processes (no builtin ``hash``) and balanced per client:
    consecutive sequence numbers from one client round-robin the shards,
    which keeps the interleaved slot streams dense — the replica executes
    in global slot order, so balance is what keeps the pipeline full.

    ``run > 1`` is the opt-in *affinity-run* variant: each client's
    sequence numbers advance shards in runs of ``run`` consecutive
    commands, so a pipelined client's burst of ``run`` requests lands on
    ONE shard leader and coalesces into one full wire batch instead of
    fragmenting ``1/num_shards``-sized crumbs across every leader (the
    4-shard batch-fragmentation regression).  Long-term balance is
    unchanged — runs still cycle all shards — and every caller that maps
    a cmd_id must agree on ``run`` (deployment route closures, the
    router, retries all hash the same id to the same shard).
    """
    if num_shards <= 1:
        return 0
    client, seq = cmd_id
    if run > 1:
        seq //= run
    return (zlib.crc32(str(client).encode()) + seq) % num_shards


class ShardRouter(Node):
    """Transport-level command router for the sharded log plane.

    Forwards each ClientRequest to the leader of the shard its command
    hashes to.  Replies flow directly from replicas to the client (the
    router is on the request path only), and retries re-route — a request
    hitting a dead shard leader is re-forwarded to the shard's new leader
    on the client's next retransmission.

    Request coalescing (the ROADMAP batching extension): constructed
    *with* a batch policy, the router merges distinct clients' commands
    bound for the same shard leader into one ``messages.Batch`` — the
    leader's ingress becomes one wire frame per coalesced burst.  Node-
    level batching is per destination, so commands for different shards
    never share a frame.

    Zero-copy relay (the shard-scaling overhaul): clients that batch
    their requests into ``messages.SealedBatch`` envelopes hit the
    ``_on_sealed`` handler, which regroups *sub-frames* per shard leader
    and forwards them as new SealedBatch envelopes.  On byte transports
    the onward frames are slices of the received bytes (the sub-frames
    are self-contained, see ``core/wire.py``) — the router never decodes
    or re-encodes a command body, only peeks each sub-frame's cmd_id.
    Fault interposition is unchanged: relayed envelopes leave through the
    normal Send effect, so every nemesis schedule sees the same
    pre-encoded message view it would for any other send.
    """

    def __init__(
        self,
        addr: Address,
        leader_providers: Sequence[Callable[[], Optional[Address]]],
        *,
        batch=None,
        affinity_run: int = 1,
    ):
        super().__init__(addr, batch=batch)
        self.leader_providers = list(leader_providers)
        # Must match the deployment's shard_of_command run parameter —
        # every hop that maps cmd_id -> shard has to agree.
        self.affinity_run = affinity_run
        # telemetry
        self.routed = 0
        self.routed_by_shard: Dict[int, int] = {}
        self.unroutable = 0
        self.relayed = 0            # sub-frames forwarded via the relay
        self.relayed_by_shard: Dict[int, int] = {}
        self.relay_batches = 0      # SealedBatch envelopes relayed onward
        self.relay_sliced = 0       # sub-frames forwarded as byte slices
        self.relay_decoded = 0      # sub-frames that needed a full decode

    @property
    def num_shards(self) -> int:
        return len(self.leader_providers)

    def _route(self, cmd_id) -> Optional[int]:
        return shard_of_command(cmd_id, self.num_shards, self.affinity_run)

    @on(m.ClientRequest)
    def _on_request(self, src: Address, msg: m.ClientRequest) -> None:
        shard = self._route(msg.command.cmd_id)
        leader = self.leader_providers[shard]()
        if leader is None:
            self.unroutable += 1  # client retry re-enters here
            return
        self.routed += 1
        self.routed_by_shard[shard] = self.routed_by_shard.get(shard, 0) + 1
        self.send(leader, msg)

    @on(m.SealedBatch)
    def _on_sealed(self, src: Address, batch: m.SealedBatch) -> None:
        """Relay a sealed request batch: regroup sub-frames per shard
        leader and forward each group as one onward SealedBatch.  Order
        within each (client, leader) pair is preserved — groups keep the
        received sub-frame order — so per-destination FIFO matches the
        decode/re-dispatch baseline exactly."""
        from . import wire  # lazy: client.py stays transport-agnostic

        if batch.raw is not None and batch.spans is not None:
            # Byte path (tcp/proc): peek each sub-frame's cmd_id, group
            # spans, and forward slices of the received buffer.
            raw = batch.raw
            groups: Dict[Address, List[Tuple[int, int]]] = {}
            for span in batch.spans:
                cmd_id = wire.peek_request_cmd_id(raw, span)
                if cmd_id is None:
                    # Not a ClientRequest: decode this one sub-frame and
                    # dispatch it like a directly-received message.
                    self.relay_decoded += 1
                    self.on_message(src, wire.sealed_messages(raw, (span,))[0])
                    continue
                shard = self._route(cmd_id)
                leader = self.leader_providers[shard]()
                if leader is None:
                    self.unroutable += 1
                    continue
                self.relay_sliced += 1
                self._note_relay(shard)
                groups.setdefault(leader, []).append(span)
            for leader, spans in groups.items():
                self.relay_batches += 1
                self.send(leader, m.SealedBatch(raw=raw, spans=tuple(spans)))
            return
        # Object path (the simulator: messages never serialize).  Same
        # grouping over live message objects.
        obj_groups: Dict[Address, List[Any]] = {}
        for sub in batch.messages:
            if type(sub) is not m.ClientRequest:
                self.relay_decoded += 1
                self.on_message(src, sub)
                continue
            shard = self._route(sub.command.cmd_id)
            leader = self.leader_providers[shard]()
            if leader is None:
                self.unroutable += 1
                continue
            self._note_relay(shard)
            obj_groups.setdefault(leader, []).append(sub)
        for leader, msgs in obj_groups.items():
            self.relay_batches += 1
            self.send(leader, m.SealedBatch(messages=tuple(msgs)))

    def _note_relay(self, shard: int) -> None:
        self.routed += 1
        self.routed_by_shard[shard] = self.routed_by_shard.get(shard, 0) + 1
        self.relayed += 1
        self.relayed_by_shard[shard] = self.relayed_by_shard.get(shard, 0) + 1

    @on(m.LeaderHint)
    def _on_leader_hint(self, src: Address, msg: m.LeaderHint) -> None:
        pass  # providers already track leadership; clients drive retries


class Client(Node):
    def __init__(
        self,
        addr: Address,
        leader_provider,
        *,
        op_factory=lambda n: b"\x00",  # the paper's one-byte no-op payload
        retry_timeout: float = 0.5,
        think_time: float = 0.0,
        max_commands: Optional[int] = None,
        route: Optional[Callable[[Tuple[str, int]], Optional[Address]]] = None,
        batch=None,
    ):
        super().__init__(addr, batch=batch)
        self.leader_provider = leader_provider  # () -> leader address
        self.route = route  # client-side shard routing: cmd_id -> address
        self.op_factory = op_factory
        self.retry_timeout = retry_timeout
        self.think_time = think_time
        self.max_commands = max_commands  # stop after this many completions
        self.seq = 0
        self.inflight: Optional[m.Command] = None
        self.sent_at = 0.0
        self.running = False
        self.done = False  # max_commands reached
        self._retry_timer = None
        # telemetry
        self.latencies: List[Tuple[float, float]] = []  # (completion time, latency)
        self.replies_by_cmd: Dict[Tuple[str, int], List[m.ClientReply]] = {}

    def start(self) -> None:
        self.running = True
        self._propose_next()

    def stop(self) -> None:
        self.running = False
        if self._retry_timer is not None:
            self._retry_timer.cancel()

    def on_restart(self) -> None:
        # The retry timer died with the crash; re-arm so the in-flight
        # command (or the next one) is driven again.
        if self.running:
            if self.inflight is not None:
                self._send_current()
            else:
                self._propose_next()

    def _propose_next(self) -> None:
        if not self.running or self.failed:
            return
        if self.max_commands is not None and self.seq >= self.max_commands:
            self.done = True
            self.stop()
            return
        self.seq += 1
        cmd = m.Command(cmd_id=(self.addr, self.seq), op=self.op_factory(self.seq))
        self.inflight = cmd
        self.sent_at = self.now
        self._send_current()

    def _target(self, cmd_id: Tuple[str, int]) -> Optional[Address]:
        if self.route is not None:
            return self.route(cmd_id)
        return self.leader_provider()

    def _send_current(self) -> None:
        if self.inflight is None:
            return
        leader = self._target(self.inflight.cmd_id)
        if leader is not None:
            self.send(leader, m.ClientRequest(command=self.inflight))
        if self._retry_timer is not None:
            self._retry_timer.cancel()
        self._retry_timer = self.set_timer(self.retry_timeout, self._send_current)

    @on(m.ClientReply)
    def _on_reply(self, src: Address, msg: m.ClientReply) -> None:
        self.replies_by_cmd.setdefault(msg.cmd_id, []).append(msg)
        if self.inflight is not None and msg.cmd_id == self.inflight.cmd_id:
            self.latencies.append((self.now, self.now - self.sent_at))
            self.inflight = None
            if self._retry_timer is not None:
                self._retry_timer.cancel()
            if self.think_time > 0:
                self.set_timer(self.think_time, self._propose_next)
            else:
                self._propose_next()

    @on(m.LeaderHint)
    def _on_leader_hint(self, src: Address, msg: m.LeaderHint) -> None:
        self._send_current()


class PipelinedClient(Node):
    """An open-window client: keeps up to ``window`` commands in flight.

    This is the workload shape of the paper's batched Section 8 deployment
    (many outstanding commands per connection); with ``window=1`` it
    degenerates to the closed-loop :class:`Client`.  Used by
    ``benchmarks/bench_batching.py`` to expose the hot-path batching win.
    """

    def __init__(
        self,
        addr: Address,
        leader_provider,
        *,
        window: int = 16,
        op_factory=lambda n: b"\x00",
        retry_timeout: float = 0.5,
        route: Optional[Callable[[Tuple[str, int]], Optional[Address]]] = None,
        batch=None,
    ):
        super().__init__(addr, batch=batch)
        self.leader_provider = leader_provider
        self.route = route
        self.window = window
        self.op_factory = op_factory
        self.retry_timeout = retry_timeout
        self.seq = 0
        self.running = False
        self.inflight: Dict[Tuple[str, int], Tuple[m.Command, float]] = {}
        self._retry_timer = None
        # telemetry
        self.completed = 0
        self.latencies: List[Tuple[float, float]] = []
        self.replies_by_cmd: Dict[Tuple[str, int], List[m.ClientReply]] = {}

    def start(self) -> None:
        self.running = True
        self._fill_window()
        self._arm_retry()

    def stop(self) -> None:
        self.running = False
        if self._retry_timer is not None:
            self._retry_timer.cancel()

    def on_restart(self) -> None:
        if self.running:
            self._fill_window()
            self._arm_retry()

    def _target(self, cmd_id: Tuple[str, int]) -> Optional[Address]:
        if self.route is not None:
            return self.route(cmd_id)
        return self.leader_provider()

    def _fill_window(self) -> None:
        while self.running and len(self.inflight) < self.window:
            self.seq += 1
            cmd = m.Command(cmd_id=(self.addr, self.seq), op=self.op_factory(self.seq))
            self.inflight[cmd.cmd_id] = (cmd, self.now)
            leader = self._target(cmd.cmd_id)
            if leader is not None:
                self.send(leader, m.ClientRequest(command=cmd))

    def _arm_retry(self) -> None:
        def fire() -> None:
            if not self.running:
                return
            cutoff = self.now - self.retry_timeout
            for cmd, sent_at in list(self.inflight.values()):
                if sent_at <= cutoff:
                    leader = self._target(cmd.cmd_id)
                    if leader is not None:
                        self.send(leader, m.ClientRequest(command=cmd))
            self._retry_timer = self.set_timer(self.retry_timeout, fire)

        self._retry_timer = self.set_timer(self.retry_timeout, fire)

    @on(m.ClientReply)
    def _on_reply(self, src: Address, msg: m.ClientReply) -> None:
        self.replies_by_cmd.setdefault(msg.cmd_id, []).append(msg)
        entry = self.inflight.pop(msg.cmd_id, None)
        if entry is None:
            return
        self.completed += 1
        self.latencies.append((self.now, self.now - entry[1]))
        if self.running:
            self._fill_window()

    @on(m.LeaderHint)
    def _on_leader_hint(self, src: Address, msg: m.LeaderHint) -> None:
        self._fill_window()
