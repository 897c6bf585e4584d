"""The Matchmaker MultiPaxos leader (Sections 3, 4, 5).

One class implements the paper's proposer (Algorithm 3) generalized to
MultiPaxos (Section 4.2), with every optimization individually flag-gated so
the Section 8.2 ablation can be reproduced:

  * Optimization 1 — Proactive Matchmaking: commands keep flowing in the old
    round (old configuration) while the Matchmaking phase of a
    reconfiguration runs (Figure 6a / "Case 1").
  * Optimization 2 — Phase 1 Bypassing: after the Matchmaking phase of a
    same-leader round bump (i -> i+1), commands are assigned slots beyond
    the last old-round slot ``k`` and go straight to Phase 2 in the new
    round/configuration (Section 4.4).  Phase 1 for slots <= k still runs in
    the background to finish any in-flight entries.
  * Optimization 3 — Garbage collection (Section 5): Scenario 1/2/3 based
    retirement of old configurations via GarbageA/GarbageB.
  * Optimization 5 — Concurrent Matchmaking & Phase 1: during a same-leader
    reconfiguration, Phase1A for the (known) current configuration is sent
    in parallel with MatchA.
  * Thriftiness: Phase2A is sent to a sampled Phase 2 quorum instead of all
    acceptors; un-acked slots fall back to a full broadcast after a timeout.

(Optimization 4 — round pruning — is a single-decree refinement; see
``single.py``.  Optimization 6 — flexible matchmaker quorums — is supported
via the ``mm_quorum_size`` parameter.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from . import messages as m
from .log import AckTracker, CommandLog, SlotOwnership, SlotState
from .oracle import Oracle
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import BatchPolicy, on
from .sim import Address, Node

__all__ = ["Options", "Proposer", "SlotState"]  # SlotState re-exported from log


@dataclass
class Options:
    proactive_matchmaking: bool = True  # Opt 1
    phase1_bypass: bool = True  # Opt 2
    garbage_collection: bool = True  # Opt 3
    concurrent_matchmaking: bool = False  # Opt 5
    thrifty: bool = True  # Section 8 "thriftiness"
    phase2_retry_timeout: float = 0.25
    heartbeat_interval: float = 0.1
    election_timeout: float = 1.0
    auto_election: bool = False
    # Hot-path batching (Section 8 batched deployment): coalesce up to
    # ``batch_max`` Phase2A/Phase2B/Chosen messages per destination,
    # flushing partial buffers every ``batch_flush_interval`` seconds.
    # batch_max=1 disables batching (the legacy byte-for-byte behaviour).
    batch_max: int = 1
    batch_flush_interval: float = 100e-6
    # Adaptive flush: instead of the fixed interval, partial buffers are
    # flushed on quiescence (when the current causal burst of handlers
    # drains), trading the fixed-interval latency floor for burst-shaped
    # batches.  See benchmarks/bench_batching.py for the tradeoff.
    batch_flush_adaptive: bool = False

    def batch_policy(self, *, sealed: bool = False) -> BatchPolicy:
        return BatchPolicy(
            max_batch=self.batch_max,
            flush_interval=self.batch_flush_interval,
            adaptive=self.batch_flush_adaptive,
            sealed=sealed,
        )


@dataclass
class MatchCtx:
    round: Round
    config: Configuration
    started: float
    is_takeover: bool
    acks: Dict[Address, m.MatchB] = field(default_factory=dict)
    done: bool = False


@dataclass
class Phase1Ctx:
    round: Round
    config: Configuration
    history: Dict[Round, Configuration] = field(default_factory=dict)
    started: float = 0.0
    acks: Dict[int, Set[Address]] = field(default_factory=dict)  # config_id -> acceptors
    votes: Dict[int, Tuple[Any, Any]] = field(default_factory=dict)  # slot -> (vr, vv)
    chosen_watermark: int = 0  # Scenario-3 watermark learned from acceptors
    from_slot: int = 0
    done: bool = False


IDLE, MATCHMAKING, PHASE1, STEADY = "IDLE", "MATCHMAKING", "PHASE1", "STEADY"


class Proposer(Node):
    def __init__(
        self,
        addr: Address,
        proposer_id: int,
        *,
        matchmakers: Tuple[Address, ...],
        replicas: Tuple[Address, ...],
        proposers: Tuple[Address, ...] = (),
        oracle: Optional[Oracle] = None,
        options: Optional[Options] = None,
        f: int = 1,
        mm_quorum_size: Optional[int] = None,  # Opt 6: default f+1
        shard: int = 0,
        num_shards: int = 1,
    ):
        opts = options or Options()
        super().__init__(addr, batch=opts.batch_policy())
        self.pid = proposer_id
        self.matchmakers = matchmakers
        self.replicas = replicas
        self.proposers = proposers
        self.oracle = oracle or Oracle()
        self.opt = opts
        self.f = f
        self.mm_quorum = mm_quorum_size or (f + 1)
        # Sharded log plane: this leader owns only the stride-partition
        # slots of its shard; all log bookkeeping goes through the
        # ownership-aware CommandLog (core/log.py).  shard=0/num_shards=1
        # is the historical own-everything leader.
        self.shard = shard
        self.ownership = SlotOwnership(shard, num_shards)

        # --- leader state ---
        self.status = IDLE
        self.round: Optional[Round] = None
        self.config: Optional[Configuration] = None
        self.is_leader = False
        self.max_witnessed: Any = NEG_INF

        self.cmdlog = CommandLog(self.ownership)
        self.queued: List[m.Command] = []
        # At-most-once index: cmd_id -> slot for every Command value in
        # ``slots``.  Kills the historical per-request linear scan (the
        # dominant wall cost of every high-throughput benchmark run);
        # entries are validated against the live SlotState on lookup, so
        # a reproposal that overwrote the slot with a noop simply falls
        # through to a fresh proposal, exactly like the scan did.
        self.cmd_index: Dict[Tuple[str, int], int] = {}

        self.match_ctx: Optional[MatchCtx] = None
        self.p1_ctx: Optional[Phase1Ctx] = None

        # --- replication / GC bookkeeping ---
        self.ack_tracker = AckTracker()  # slots < watermark on >= f+1 replicas
        self.stored_acks: Dict[Round, Set[Address]] = {}
        self.gc_pending_round: Optional[Round] = None
        self.gc_acks: Dict[Round, Set[Address]] = {}
        self.gc_started_at = 0.0
        self.retired_config_ids: Set[int] = set()
        self.active_history: Dict[Round, Configuration] = {}

        # --- recovery (takeover) ---
        self.recover_acks: Dict[Address, m.RecoverB] = {}
        self.recovered = True

        # --- election ---
        self.leader_addr: Optional[Address] = None
        self.last_heartbeat = 0.0
        self._hb_timer = None
        self._election_timer = None
        self._election_cfg_provider: Optional[Callable[[], Configuration]] = None

        # --- telemetry ---
        self.reconfig_log: List[Dict[str, float]] = []
        self.stall_count = 0

    # ------------------------------------------------------------------
    # Log bookkeeping lives in the CommandLog; these views keep the
    # historical field names (tests, invariant checker, scenario scripts).
    # ------------------------------------------------------------------
    @property
    def slots(self) -> Dict[int, SlotState]:
        return self.cmdlog.slots

    @property
    def chosen_values(self) -> Dict[int, Any]:
        return self.cmdlog.chosen_values

    @property
    def chosen_watermark(self) -> int:
        return self.cmdlog.chosen_watermark

    @property
    def next_slot(self) -> int:
        return self.cmdlog.next_slot

    @property
    def replica_acks(self) -> Dict[Address, int]:
        return self.ack_tracker.acks

    @property
    def replicated_watermark(self) -> int:
        return self.ack_tracker.watermark

    # ------------------------------------------------------------------
    # Crash/restart fault model (nemesis)
    # ------------------------------------------------------------------
    def reset_volatile(self) -> None:
        """kill -9 semantics: leadership and in-flight round state live in
        process memory and die with the process.  The chosen log does not
        need to be persisted for safety — a recovering leader re-learns it
        from the replicas/acceptors via Phase 1 — but leadership must never
        silently survive a crash (the ex-leader would keep proposing in a
        round a successor has already superseded without re-running
        Phase 1)."""
        self.is_leader = False
        self.status = IDLE
        self.match_ctx = None
        self.p1_ctx = None
        self.queued.clear()
        self.recovered = True
        if self._hb_timer is not None:
            self._hb_timer.cancel()
            self._hb_timer = None

    def on_restart(self) -> None:
        # Timers were suppressed while crashed; re-arm the election watch
        # so a restarted follower can still take over a dead leader.
        if self._election_cfg_provider is not None:
            self.start_election_watch(self._election_cfg_provider)

    # ------------------------------------------------------------------
    # Leadership / round management
    # ------------------------------------------------------------------
    def set_matchmakers(self, matchmakers: Tuple[Address, ...]) -> None:
        """Point at a new matchmaker set (after a Section 6 reconfiguration)."""
        self.matchmakers = tuple(matchmakers)

    @on(m.SetMatchmakers)
    def _on_set_matchmakers(self, src: Address, msg: m.SetMatchmakers) -> None:
        # The message form of the coordinator's on_complete callback: the
        # proc plane's processes have no shared memory to call through.
        self.set_matchmakers(msg.matchmakers)

    def become_leader(self, config: Configuration) -> None:
        """Take over leadership (full Phase 1; no bypass)."""
        base = self.max_witnessed if self.max_witnessed != NEG_INF else None
        if self.round is not None and (base is None or self.round > base):
            base = self.round
        new_round = (
            Round(0, self.pid, 0)
            if base is None or base == NEG_INF
            else base.next_r(self.pid)
        )
        self.is_leader = True
        self.leader_addr = self.addr
        self._start_round(new_round, config, is_takeover=True)
        self._start_heartbeats()

    def reconfigure(self, config: Configuration) -> None:
        """Stable-leader reconfiguration: bump ``s`` (Section 4.3)."""
        assert self.is_leader and self.round is not None
        self._start_round(self.round.next_s(), config, is_takeover=False)

    def _start_round(
        self, rnd: Round, config: Configuration, *, is_takeover: bool
    ) -> None:
        self.match_ctx = MatchCtx(
            round=rnd, config=config, started=self.now, is_takeover=is_takeover
        )
        self.status = MATCHMAKING
        if is_takeover:
            # Learn the chosen prefix from the replicas (Section 4.1: "by
            # communicating with ... the replicas").
            self.recovered = False
            self.recover_acks = {}
            self.broadcast(self.replicas, m.RecoverA())
        self.broadcast(
            self.matchmakers, m.MatchA(round=rnd, config=config, shard=self.shard)
        )
        if self.opt.concurrent_matchmaking and not is_takeover and self.config:
            # Opt 5: we know H will contain (at least) our current config —
            # start Phase 1 with it concurrently with the Matchmaking phase.
            pre = Phase1Ctx(round=rnd, config=config, started=self.now)
            pre.history = dict(self.active_history)
            pre.from_slot = self.replicated_watermark
            self.p1_ctx = pre
            for c in pre.history.values():
                self.broadcast(
                    c.acceptors, m.Phase1A(round=rnd, from_slot=pre.from_slot)
                )
        elif not self.opt.concurrent_matchmaking:
            self.p1_ctx = None
        self._resend_timer(rnd)

    def _resend_timer(self, rnd: Round) -> None:
        def resend() -> None:
            ctx = self.match_ctx
            if ctx is not None and ctx.round == rnd and not ctx.done and self.is_leader:
                self.broadcast(
                    self.matchmakers,
                    m.MatchA(round=rnd, config=ctx.config, shard=self.shard),
                )
                self._resend_timer(rnd)

        self.set_timer(self.opt.phase2_retry_timeout, resend)

    # ------------------------------------------------------------------
    # Message handlers (typed dispatch; registry built by ProtocolNode)
    # ------------------------------------------------------------------
    @on(m.MatchNack)
    def _on_match_nack(self, src: Address, msg: m.MatchNack) -> None:
        self._on_nack(msg.witnessed)

    @on(m.Phase1Nack)
    def _on_phase1_nack(self, src: Address, msg: m.Phase1Nack) -> None:
        self._on_nack(msg.witnessed)

    @on(m.Ping)
    def _on_ping(self, src: Address, msg: m.Ping) -> None:
        # Failure detectors probe shard leaders directly (shard-aware
        # failover in coord/control_plane.attach_detector).
        self.send(src, m.Pong(msg.nonce))

    @on(m.Heartbeat)
    def _on_heartbeat(self, src: Address, msg: m.Heartbeat) -> None:
        self.last_heartbeat = self.now
        if msg.round is not None and (self.round is None or msg.round >= self.round):
            self.leader_addr = src

    @on(m.Chosen)
    def _on_chosen(self, src: Address, msg: m.Chosen) -> None:
        self._learn_chosen(msg.slot, msg.value, external=True)

    # ------------------------------------------------------------------
    # Client commands
    # ------------------------------------------------------------------
    @on(m.ClientRequest)
    def _on_client_request(self, src: Address, msg: m.ClientRequest) -> None:
        if not self.is_leader:
            if self.leader_addr and self.leader_addr != self.addr:
                self.send(src, m.LeaderHint(leader=self.leader_addr))
            return
        cmd = msg.command
        # At-most-once: an already-chosen command is re-broadcast, not
        # re-proposed in a fresh slot.  O(1) via the cmd_index.
        slot = self.cmd_index.get(cmd.cmd_id)
        if slot is not None:
            st = self.slots.get(slot)
            if (
                st is not None
                and type(st.value) is m.Command
                and st.value.cmd_id == cmd.cmd_id
            ):
                if st.chosen:
                    self.broadcast(self.replicas, m.Chosen(slot=slot, value=st.value))
                return
            del self.cmd_index[cmd.cmd_id]  # stale (slot was re-proposed)
        if self.status == STEADY:
            self._propose(cmd)
        elif self.status == MATCHMAKING and self.opt.proactive_matchmaking and (
            self.match_ctx is not None and not self.match_ctx.is_takeover
        ):
            # Opt 1 / Case 1: the old configuration is oblivious to the
            # Matchmaking phase — keep proposing in the old round.
            self._propose(cmd)
        elif self.status == PHASE1 and self.opt.phase1_bypass and (
            self.match_ctx is not None and not self.match_ctx.is_takeover
        ):
            # Opt 2 / Case 3: bypass Phase 1 for fresh slots in the new round.
            self._propose(cmd)
        else:
            self.stall_count += 1
            self.queued.append(cmd)

    @on(m.FillRequest)
    def _on_fill_request(self, src: Address, msg: m.FillRequest) -> None:
        """A replica's execution is blocked on holes below ``msg.slot``
        (sharded log plane): an idle shard must not stall global
        execution, so noop-fill every *owned* slot up through the
        requested frontier (Mencius-style skip).  Slots already claimed
        are being driven by Phase-2 retries and are left alone."""
        if not self.is_leader or self.status != STEADY:
            return
        while self.next_slot <= msg.slot:
            self._propose(m.NOOP)  # claim() only ever takes owned slots

    def _propose(self, value: Any, slot: Optional[int] = None) -> None:
        assert self.round is not None and self.config is not None
        if slot is None:
            slot = self.cmdlog.claim()  # next slot this shard owns
        st = SlotState(value=value, round=self.round, config=self.config)
        self.slots[slot] = st
        if type(value) is m.Command:
            self.cmd_index[value.cmd_id] = slot
        self._send_phase2a(slot, thrifty=self.opt.thrifty)

    def _send_phase2a(self, slot: int, *, thrifty: bool) -> None:
        st = self.slots[slot]
        targets = (
            st.config.phase2.sample(self.rng) if thrifty else st.config.acceptors
        )
        for a in targets:
            self.send(a, m.Phase2A(round=st.round, slot=slot, value=st.value))
        rnd = st.round

        def retry() -> None:
            cur = self.slots.get(slot)
            if cur is not None and not cur.chosen and cur.round == rnd and self.is_leader:
                # Thrifty fallback: rebroadcast to every acceptor.
                self._send_phase2a(slot, thrifty=False)

        self.set_timer(self.opt.phase2_retry_timeout, retry)

    # ------------------------------------------------------------------
    # Matchmaking phase
    # ------------------------------------------------------------------
    @on(m.MatchB)
    def _on_match_b(self, src: Address, msg: m.MatchB) -> None:
        ctx = self.match_ctx
        if ctx is None or ctx.done or msg.round != ctx.round:
            return
        ctx.acks[src] = msg
        if len(ctx.acks) < self.mm_quorum:
            return
        ctx.done = True
        # H_i = union of histories; prune rounds below the max GC watermark
        # (Section 5: "if any of the f+1 matchmakers have garbage collected
        # round j, then the proposer also garbage collects round j").
        history: Dict[Round, Configuration] = {}
        gc_w: Any = NEG_INF
        for b in ctx.acks.values():
            gc_w = max_round(gc_w, b.gc_watermark)
            for j, cj in b.history:
                history[j] = cj
        history = {j: c for j, c in history.items() if not (j < gc_w)}
        self.oracle.on_matchmaking_complete(len(history))

        # Enter the new round.
        prev_round, prev_config = self.round, self.config
        self.round, self.config = ctx.round, ctx.config
        self.active_history = dict(history)
        self.active_history[ctx.round] = ctx.config

        if self.p1_ctx is not None and self.p1_ctx.round == ctx.round:
            # Opt 5 pre-started Phase 1: reconcile against the real history.
            p1 = self.p1_ctx
            missing = {j: c for j, c in history.items() if j not in p1.history}
            p1.history.update(missing)
            for c in missing.values():
                self.broadcast(
                    c.acceptors, m.Phase1A(round=ctx.round, from_slot=p1.from_slot)
                )
        else:
            p1 = Phase1Ctx(
                round=ctx.round,
                config=ctx.config,
                history=dict(history),
                started=self.now,
                from_slot=self.replicated_watermark,
            )
            self.p1_ctx = p1
            for c in p1.history.values():
                self.broadcast(
                    c.acceptors, m.Phase1A(round=ctx.round, from_slot=p1.from_slot)
                )
        self.status = PHASE1
        if self.opt.phase1_bypass and not ctx.is_takeover:
            # Section 4.4: commands from here on take slots > k and run
            # Phase 2 in the new round immediately; flush anything queued.
            self._flush_queued()
        self._maybe_phase1_done()  # history may be empty

    # ------------------------------------------------------------------
    # Phase 1
    # ------------------------------------------------------------------
    @on(m.Phase1B)
    def _on_phase1b(self, src: Address, msg: m.Phase1B) -> None:
        p1 = self.p1_ctx
        if p1 is None or p1.done or msg.round != p1.round:
            return
        for cfg in p1.history.values():
            if src in cfg.acceptors:
                p1.acks.setdefault(cfg.config_id, set()).add(src)
        for v in msg.votes:
            cur = p1.votes.get(v.slot)
            if cur is None or cur[0] < v.vr:
                p1.votes[v.slot] = (v.vr, v.vv)
        p1.chosen_watermark = max(p1.chosen_watermark, msg.chosen_watermark)
        self._maybe_phase1_done()

    def _maybe_phase1_done(self) -> None:
        p1 = self.p1_ctx
        if p1 is None or p1.done or self.status != PHASE1:
            return
        if self.match_ctx is not None and not self.match_ctx.done:
            return  # Opt 5: matchmaking must finish before Phase 1 can end
        for cfg in p1.history.values():
            acks = p1.acks.get(cfg.config_id, set())
            if not cfg.phase1.is_quorum(acks):
                return
        if not self.recovered:
            return  # takeover: wait for the replica prefix
        p1.done = True
        self._finish_phase1(p1)

    def _finish_phase1(self, p1: Phase1Ctx) -> None:
        """Compute safe values (Figure 5) and enter the steady state."""
        was_takeover = self.match_ctx.is_takeover if self.match_ctx else False
        # Slots below the Scenario-3 watermark are chosen; fetched from
        # replicas (RecoverB) rather than re-proposed.
        floor = max(p1.chosen_watermark, p1.from_slot, self.chosen_watermark)
        max_voted = max(p1.votes.keys(), default=-1)
        horizon = max(max_voted + 1, self.next_slot, floor)
        self.cmdlog.raise_horizon(horizon)
        # Only slots this shard OWNS are resolved/noop-filled: a slot owned
        # by another shard is decided by that shard's acceptor group, and
        # filling it here would be a double-choose.
        for slot in self.cmdlog.reproposal_range(floor, horizon):
            existing = self.slots.get(slot)
            if existing is not None and existing.chosen:
                continue
            vote = p1.votes.get(slot)
            if vote is not None and vote[0] != NEG_INF:
                value = vote[1]  # max-vr vote value (Algorithm 3 line 12)
            elif existing is not None:
                value = existing.value  # our own in-flight proposal
            else:
                value = m.NOOP  # hole (Section 4.1)
            st = SlotState(
                value=value,
                round=p1.round,
                config=p1.config,
                is_reproposal=True,
            )
            self.slots[slot] = st
            if type(value) is m.Command:
                self.cmd_index[value.cmd_id] = slot
            self._send_phase2a(slot, thrifty=self.opt.thrifty)
        self.status = STEADY
        self._flush_queued()
        if self.match_ctx is not None:
            self.oracle.on_reconfig_complete(self.match_ctx.started, self.now)
            self.reconfig_log.append(
                {
                    "round": str(p1.round),
                    "started": self.match_ctx.started,
                    "steady": self.now,
                    "takeover": float(was_takeover),
                    "history_size": len(p1.history) - 1
                    if p1.round in p1.history
                    else len(p1.history),
                }
            )
        self._maybe_gc()

    def _flush_queued(self) -> None:
        queued, self.queued = self.queued, []
        for cmd in queued:
            self._propose(cmd)

    # ------------------------------------------------------------------
    # Phase 2
    # ------------------------------------------------------------------
    @on(m.Phase2B)
    def _on_phase2b(self, src: Address, msg: m.Phase2B) -> None:
        st = self.slots.get(msg.slot)
        if st is None or st.chosen or st.round != msg.round:
            return
        st.acks.add(src)
        if st.config.phase2.is_quorum(st.acks):
            self._learn_chosen(msg.slot, st.value)

    def _learn_chosen(self, slot: int, value: Any, external: bool = False) -> None:
        st = self.slots.get(slot)
        if st is not None:
            if st.chosen:
                return
            st.chosen = True
            st.value = value
        elif self.config is not None:
            self.slots[slot] = SlotState(
                value=value,
                round=self.round or Round(0, self.pid, 0),
                config=self.config,
                chosen=True,
            )
            self.cmdlog.note_seen(slot)
        else:
            # A Chosen arrived before our first round is active (e.g. a
            # follower learning from the leader's broadcast): record the
            # value but never fabricate a SlotState with config=None.
            self.cmdlog.note_seen(slot)
        if type(value) is m.Command and slot in self.slots:
            self.cmd_index[value.cmd_id] = slot
        self.cmdlog.mark_chosen(slot, value)
        if not external:
            self.oracle.on_chosen(slot, value, st.round if st else None, self.now, self.addr)
            self.broadcast(self.replicas, m.Chosen(slot=slot, value=value))
        self._maybe_gc()

    @on(m.Phase2Nack)
    def _on_phase2_nack(self, src: Address, msg: m.Phase2Nack) -> None:
        # A nack from our *own* newer round is a benign reconfiguration race
        # (Figure 6b): the slot will be re-proposed when Phase 1 finishes.
        if isinstance(msg.witnessed, Round) and msg.witnessed.proposer == self.pid:
            return
        self._on_nack(msg.witnessed)

    def _on_nack(self, witnessed: Any) -> None:
        if witnessed == NEG_INF or witnessed is None:
            return
        self.max_witnessed = max_round(self.max_witnessed, witnessed)
        if (
            self.is_leader
            and isinstance(witnessed, Round)
            and witnessed.proposer != self.pid
            and (self.round is None or witnessed > self.round)
        ):
            # Someone with a larger round exists: step down.
            self.is_leader = False
            self.status = IDLE
            if self._hb_timer is not None:
                self._hb_timer.cancel()

    # ------------------------------------------------------------------
    # Recovery (takeover)
    # ------------------------------------------------------------------
    @on(m.RecoverB)
    def _on_recover_b(self, src: Address, msg: m.RecoverB) -> None:
        if self.recovered:
            return
        self.recover_acks[src] = msg
        if len(self.recover_acks) < min(self.f + 1, len(self.replicas)):
            return
        for b in self.recover_acks.values():
            for slot, value in b.entries:
                if slot not in self.chosen_values:
                    self.chosen_values[slot] = value
                    self.slots[slot] = SlotState(
                        value=value,
                        round=self.round or Round(0, self.pid, 0),
                        config=self.config,
                        chosen=True,
                    )
                    if type(value) is m.Command:
                        self.cmd_index[value.cmd_id] = slot
                    self.broadcast(self.replicas, m.Chosen(slot=slot, value=value))
        # Recovered entries cover ALL shards' slots; next_slot realigns to
        # the next slot this shard owns beyond anything seen.
        for s in self.chosen_values:
            self.cmdlog.note_seen(s)
        self.cmdlog.advance_watermark()
        self.recovered = True
        self._maybe_phase1_done()

    # ------------------------------------------------------------------
    # Replication watermark + garbage collection (Section 5)
    # ------------------------------------------------------------------
    @on(m.ReplicaAck)
    def _on_replica_ack(self, src: Address, msg: m.ReplicaAck) -> None:
        self.ack_tracker.observe(src, msg.watermark)
        self.ack_tracker.quorum_watermark(min(self.f + 1, len(self.replicas)))
        self._maybe_gc()

    def _maybe_gc(self) -> None:
        """Issue GarbageA(i) once every slot satisfies a GC scenario
        (Section 5.3): the replicated prefix is Scenario 3, the middle
        entries we chose in round i are Scenario 1, the empty tail is
        Scenario 2."""
        if not self.opt.garbage_collection or not self.is_leader:
            return
        if self.status != STEADY or self.round is None:
            return
        if self.gc_pending_round == self.round or self.round in self.gc_acks:
            return
        old_rounds = [j for j in self.active_history if j < self.round]
        if not old_rounds:
            return
        p1 = self.p1_ctx
        if p1 is None or not p1.done or p1.round != self.round:
            return
        # Scenario 1: everything Phase 1 surfaced must be chosen in round i
        # (owned slots only — other shards' slots are other shards' GC).
        for slot in self.cmdlog.reproposal_range(p1.from_slot, self.next_slot):
            st = self.slots.get(slot)
            if st is None or not st.chosen:
                if slot < max(p1.votes.keys(), default=-1) + 1 or st is not None:
                    return
        # Scenario 3: the prefix below from_slot is on f+1 replicas...
        if self.replicated_watermark < p1.from_slot:
            return
        # ...and a Phase 2 quorum of C_i must be told before GC.
        acked = self.stored_acks.get(self.round, set())
        if not self.config.phase2.is_quorum(acked):
            self.broadcast(
                self.config.acceptors,
                m.StoredWatermark(round=self.round, watermark=self.replicated_watermark),
            )
            return  # resumes from _on_stored_ack
        self.gc_pending_round = self.round
        self.gc_started_at = self.now
        self.gc_acks[self.round] = set()
        self.broadcast(
            self.matchmakers, m.GarbageA(round=self.round, shard=self.shard)
        )

    @on(m.StoredWatermarkAck)
    def _on_stored_ack(self, src: Address, msg: m.StoredWatermarkAck) -> None:
        self.stored_acks.setdefault(msg.round, set()).add(src)
        self._maybe_gc()

    @on(m.GarbageB)
    def _on_garbage_b(self, src: Address, msg: m.GarbageB) -> None:
        acks = self.gc_acks.get(msg.round)
        if acks is None:
            return
        acks.add(src)
        if len(acks) >= self.mm_quorum and self.gc_pending_round == msg.round:
            self.gc_pending_round = None
            self.oracle.on_gc_complete(self.gc_started_at, self.now)
            # Old configurations may now be shut down (Section 5.1).
            for j in list(self.active_history):
                if j < msg.round:
                    self.retired_config_ids.add(self.active_history[j].config_id)
                    del self.active_history[j]

    # ------------------------------------------------------------------
    # Heartbeats / election
    # ------------------------------------------------------------------
    def _start_heartbeats(self) -> None:
        if self._hb_timer is not None:
            self._hb_timer.cancel()

        def beat() -> None:
            if not self.is_leader:
                return
            for p in self.proposers:
                if p != self.addr:
                    self.send(p, m.Heartbeat(round=self.round))
            self._hb_timer = self.set_timer(self.opt.heartbeat_interval, beat)

        beat()

    def start_election_watch(self, config_provider: Callable[[], Configuration]) -> None:
        """Followers call this to auto-takeover on leader silence."""
        self._election_cfg_provider = config_provider
        if self._election_timer is not None:
            self._election_timer.cancel()

        def check() -> None:
            if not self.is_leader and self.opt.auto_election:
                stagger = self.opt.election_timeout * (1 + 0.5 * self.pid)
                if self.now - self.last_heartbeat > stagger:
                    self.become_leader(config_provider())
            self._election_timer = self.set_timer(
                self.opt.election_timeout / 2, check
            )

        self.last_heartbeat = self.now
        self._election_timer = self.set_timer(self.opt.election_timeout, check)
