"""Matchmaker reconfiguration (Section 6).

The coordinator replaces the matchmaker set ``M_old`` with ``M_new``:

  1. ``StopA`` -> every matchmaker in ``M_old``; await f+1 ``StopB(L_i, w_i)``.
  2. Merge: ``w = max w_i``; ``L = union L_i`` minus entries in rounds < w
     (Figure 7).
  3. Choose ``M_new`` via single-decree Paxos *among the old matchmakers*
     (they double as Paxos acceptors) so two concurrent reconfigurations
     cannot install disjoint sets.
  4. ``Bootstrap(L, w)`` -> every matchmaker in ``M_new``; await f+1 acks.
  5. ``MMEnable`` -> ``M_new``; announce the new set to the proposers.

Because matchmakers are contacted only on round changes, all of this is off
the critical path of command processing (Figure 21's claim).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from . import messages as m
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import on
from .sim import Address, Node


@dataclass
class MMReconfigStats:
    started: float = 0.0
    stopped_at: float = 0.0        # f+1 StopBs gathered
    chosen_at: float = 0.0         # M_new chosen by Paxos
    enabled_at: float = 0.0        # M_new bootstrapped + enabled


class MMReconfigCoordinator(Node):
    """Drives one matchmaker reconfiguration at a time.

    ``on_complete(new_set)`` is invoked (in simulation time) once ``M_new``
    is live; the caller is responsible for pointing proposers at the new
    set (``Proposer.set_matchmakers``).
    """

    def __init__(
        self,
        addr: Address,
        coordinator_id: int,
        *,
        f: int = 1,
        on_complete: Optional[Callable[[Tuple[Address, ...]], None]] = None,
        notify_proposers: Tuple[Address, ...] = (),
        retry_timeout: float = 0.25,
    ):
        super().__init__(addr)
        self.cid = coordinator_id
        self.f = f
        self.on_complete = on_complete
        # Message-based completion fan-out (the proc plane: proposers live
        # in other OS processes, so a shared-memory callback can't reach
        # them).  Works alongside on_complete; either may be unset.
        self.notify_proposers = tuple(notify_proposers)
        self.retry_timeout = retry_timeout

        self.m_old: Tuple[Address, ...] = ()
        self.m_new: Tuple[Address, ...] = ()
        self.phase = "idle"
        self.ballot: Optional[Round] = None
        self.max_witnessed: Any = NEG_INF

        self._stop_acks: Dict[Address, m.StopB] = {}
        self._p1_acks: Dict[Address, m.MMP1B] = {}
        self._p2_acks: Set[Address] = set()
        self._boot_acks: Set[Address] = set()
        self._merged_log: Tuple[Tuple[Round, Configuration], ...] = ()
        self._merged_w: Any = NEG_INF
        self._merged_shard_logs: Tuple[m.ShardLogSnapshot, ...] = ()
        self.stats = MMReconfigStats()

    def mc_state(self) -> Dict[str, Any]:
        """Model-checker fingerprint state (core/mc.py): the coordinator
        is all volatile — its phase machine, ballot, gathered acks and the
        merged log it will bootstrap from all steer future transitions."""
        return {
            "cid": self.cid,
            "phase": self.phase,
            "m_old": self.m_old,
            "m_new": self.m_new,
            "ballot": self.ballot,
            "max_witnessed": self.max_witnessed,
            "stop_acks": self._stop_acks,
            "p1_acks": self._p1_acks,
            "p2_acks": self._p2_acks,
            "boot_acks": self._boot_acks,
            "merged_log": self._merged_log,
            "merged_w": self._merged_w,
            "merged_shard_logs": self._merged_shard_logs,
            "candidate": getattr(self, "_chosen_candidate", None),
        }

    # ------------------------------------------------------------------
    def reconfigure(self, m_old: Tuple[Address, ...], m_new: Tuple[Address, ...]) -> None:
        assert self.phase == "idle", "one reconfiguration at a time"
        self.m_old = tuple(m_old)
        self.m_new = tuple(m_new)
        self.phase = "stopping"
        self.stats = MMReconfigStats(started=self.now)
        self._stop_acks = {}
        self.broadcast(self.m_old, m.StopA())
        self._arm_retry("stopping", lambda: self.broadcast(self.m_old, m.StopA()))

    def _arm_retry(self, phase: str, resend: Callable[[], None]) -> None:
        def fire() -> None:
            if self.phase == phase:
                resend()
                self._arm_retry(phase, resend)

        self.set_timer(self.retry_timeout, fire)

    # ------------------------------------------------------------------
    @on(m.MMNack)
    def _on_mm_nack(self, src: Address, msg: m.MMNack) -> None:
        self.max_witnessed = max_round(self.max_witnessed, msg.ballot)

    # -- step 1/2: stop + merge -----------------------------------------
    @on(m.StopB)
    def _on_stop_b(self, src: Address, msg: m.StopB) -> None:
        if self.phase != "stopping":
            return
        self._stop_acks[src] = msg
        if len(self._stop_acks) < self.f + 1:
            return
        self.stats.stopped_at = self.now
        # Figure 7, applied uniformly per shard (shard 0 travels in
        # StopB's historical log/gc_watermark fields): union the logs,
        # take the max watermark, drop entries below it.
        per_shard: Dict[int, Dict[Round, Configuration]] = {}
        per_w: Dict[int, Any] = {}
        for b in self._stop_acks.values():
            for s, log, sw in ((0, b.log, b.gc_watermark),) + tuple(b.shard_logs):
                per_w[s] = max_round(per_w.get(s, NEG_INF), sw)
                for j, c in log:
                    per_shard.setdefault(s, {})[j] = c

        def pruned(s: int) -> Tuple[Tuple[Round, Configuration], ...]:
            w = per_w.get(s, NEG_INF)
            return tuple(
                sorted(
                    ((j, c) for j, c in per_shard.get(s, {}).items() if not (j < w)),
                    key=lambda jc: jc[0].key(),
                )
            )

        self._merged_log = pruned(0)
        self._merged_w = per_w.get(0, NEG_INF)
        self._merged_shard_logs = tuple(
            (s, pruned(s), per_w[s])
            for s in sorted(set(per_shard) | set(per_w))
            if s != 0
        )
        # -- step 3: choose M_new among the old matchmakers --------------
        self.phase = "choosing"
        base = self.max_witnessed
        self.ballot = (
            Round(0, self.cid, 0) if base == NEG_INF else base.next_r(self.cid)
        )
        self._p1_acks = {}
        self._p2_acks = set()
        self.broadcast(self.m_old, m.MMP1A(ballot=self.ballot))
        self._arm_retry("choosing", self._restart_choice)

    def _restart_choice(self) -> None:
        base = max_round(self.max_witnessed, self.ballot)
        self.ballot = base.next_r(self.cid)
        self._p1_acks = {}
        self._p2_acks = set()
        self.broadcast(self.m_old, m.MMP1A(ballot=self.ballot))

    @on(m.MMP1B)
    def _on_mm_p1b(self, src: Address, msg: m.MMP1B) -> None:
        if self.phase != "choosing" or msg.ballot != self.ballot:
            return
        self._p1_acks[src] = msg
        if len(self._p1_acks) < self.f + 1:
            return
        # Standard Paxos value selection: adopt the highest-ballot vote.
        best_vb: Any = NEG_INF
        value: Any = self.m_new
        for b in self._p1_acks.values():
            if b.vb != NEG_INF and best_vb < b.vb:
                best_vb, value = b.vb, b.vv
        self._chosen_candidate = tuple(value)
        self.phase = "proposing"
        self.broadcast(self.m_old, m.MMP2A(ballot=self.ballot, value=self._chosen_candidate))
        self._arm_retry(
            "proposing",
            lambda: self.broadcast(
                self.m_old, m.MMP2A(ballot=self.ballot, value=self._chosen_candidate)
            ),
        )

    @on(m.MMP2B)
    def _on_mm_p2b(self, src: Address, msg: m.MMP2B) -> None:
        if self.phase != "proposing" or msg.ballot != self.ballot:
            return
        self._p2_acks.add(src)
        if len(self._p2_acks) < self.f + 1:
            return
        # M_new chosen.  If another coordinator won, adopt its set.
        self.m_new = self._chosen_candidate
        self.stats.chosen_at = self.now
        # -- step 4: bootstrap the new matchmakers ------------------------
        self.phase = "bootstrapping"
        self._boot_acks = set()
        boot = m.Bootstrap(
            log=self._merged_log,
            gc_watermark=self._merged_w,
            shard_logs=self._merged_shard_logs,
        )
        self.broadcast(self.m_new, boot)
        self._arm_retry("bootstrapping", lambda: self.broadcast(self.m_new, boot))

    # -- step 5: enable ---------------------------------------------------
    @on(m.BootstrapAck)
    def _on_bootstrap_ack(self, src: Address, msg: m.BootstrapAck) -> None:
        if self.phase != "bootstrapping":
            return
        self._boot_acks.add(src)
        if len(self._boot_acks) < self.f + 1:
            return
        self.phase = "idle"
        self.stats.enabled_at = self.now
        self.broadcast(self.m_new, m.MMEnable())
        if self.notify_proposers:
            self.broadcast(
                self.notify_proposers, m.SetMatchmakers(matchmakers=self.m_new)
            )
        if self.on_complete is not None:
            self.on_complete(self.m_new)
