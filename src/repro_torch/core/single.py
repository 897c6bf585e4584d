"""Single-decree Matchmaker Paxos (Algorithms 1-3, verbatim).

This is the protocol exactly as presented in Section 3 — one instance of
consensus, one value — used by the property-based safety tests and by the
Optimization 4 (round pruning) implementation, which the paper states for
the single-decree protocol.

Garbage-collection Scenarios 1 and 2 of Section 5.2 are implemented here:
a proposer that gets a value chosen (Scenario 1) or observes ``k = -1``
after Phase 1 (Scenario 2) issues ``GarbageA(i)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set, Tuple

from . import messages as m
from .log import CommandLog
from .oracle import Oracle
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import on
from .sim import Address, Node

SLOT = 0  # single decree: everything lives at slot 0


class SingleDecreeProposer(Node):
    """Algorithm 3, plus Opt 4 (round pruning) and GC Scenarios 1/2."""

    def __init__(
        self,
        addr: Address,
        proposer_id: int,
        *,
        matchmakers: Tuple[Address, ...],
        oracle: Oracle,
        config_provider: Callable[[int], Configuration],
        f: int = 1,
        round_pruning: bool = True,  # Opt 4
        gc_enabled: bool = False,  # Scenarios 1/2
        retry: bool = True,
        retry_backoff: float = 0.05,
        max_attempts: int = 50,
    ):
        super().__init__(addr)
        self.pid = proposer_id
        self.matchmakers = matchmakers
        self.oracle = oracle
        self.config_provider = config_provider
        self.f = f
        self.round_pruning = round_pruning
        self.gc_enabled = gc_enabled
        self.retry = retry
        self.retry_backoff = retry_backoff
        self.max_attempts = max_attempts

        self.value: Any = None  # x, the value we want chosen
        self.round: Optional[Round] = None  # i
        self.config: Optional[Configuration] = None  # C_i
        self.history: Dict[Round, Configuration] = {}  # H_i
        self.attempt = 0
        self.max_witnessed: Any = NEG_INF

        self._match_acks: Dict[Address, m.MatchB] = {}
        self._p1_acks: Dict[int, Set[Address]] = {}
        self._p2_acks: Set[Address] = set()
        self._k: Any = NEG_INF
        self._kv: Any = None
        self._prune_floor: Any = NEG_INF
        self._phase = "idle"
        # Single-decree = a one-slot CommandLog (the same bookkeeping
        # abstraction the MultiPaxos and horizontal leaders consume).
        self.cmdlog = CommandLog()
        self.k_was_neg1 = False

    @property
    def chosen_value(self) -> Any:
        return self.cmdlog.chosen_values.get(SLOT)

    def mc_state(self) -> Dict[str, Any]:
        """Model-checker fingerprint state (core/mc.py): the proposer is
        all volatile, so everything that steers a future transition goes
        in — phase, round, gathered acks, the Phase-1 fold (k, kv, prune
        floor) and the learned value.  Telemetry stays out."""
        return {
            "pid": self.pid,
            "matchmakers": self.matchmakers,
            "value": self.value,
            "round": self.round,
            "config": self.config,
            "history": self.history,
            "attempt": self.attempt,
            "max_witnessed": self.max_witnessed,
            "match_acks": self._match_acks,
            "p1_acks": self._p1_acks,
            "p2_acks": self._p2_acks,
            "k": self._k,
            "kv": self._kv,
            "prune_floor": self._prune_floor,
            "phase": self._phase,
            "chosen": self.cmdlog.chosen_values,
        }

    # ------------------------------------------------------------------
    def propose(self, value: Any) -> None:
        """Client entry point (Algorithm 3 line 1)."""
        self.value = value
        self._next_attempt()

    def _next_attempt(self) -> None:
        if self.chosen_value is not None or self.failed:
            return
        self.attempt += 1
        if self.attempt > self.max_attempts:
            return
        base = self.max_witnessed
        if self.round is not None:
            base = max_round(base, self.round)
        self.round = (
            Round(0, self.pid, 0) if base == NEG_INF else base.next_r(self.pid)
        )
        self.config = self.config_provider(self.attempt)
        self.history = {}
        self._match_acks = {}
        self._p1_acks = {}
        self._p2_acks = set()
        self._k, self._kv = NEG_INF, None
        self._prune_floor = NEG_INF
        self._phase = "matchmaking"
        self.broadcast(
            self.matchmakers, m.MatchA(round=self.round, config=self.config)
        )
        if self.retry:
            rnd = self.round
            self.set_timer(
                self.retry_backoff * (1 + 0.1 * self.pid),
                lambda: self._retry_if_stuck(rnd),
            )

    def _retry_if_stuck(self, rnd: Round) -> None:
        if self.chosen_value is None and self.round == rnd and self.retry:
            self._next_attempt()

    # ------------------------------------------------------------------
    @on(m.MatchNack, m.Phase1Nack, m.Phase2Nack)
    def _on_any_nack(self, src: Address, msg: Any) -> None:
        self._on_nack(msg.witnessed)

    def _on_nack(self, witnessed: Any) -> None:
        if isinstance(witnessed, Round):
            self.max_witnessed = max_round(self.max_witnessed, witnessed)

    # -- Matchmaking (Algorithm 3 lines 6-8) ----------------------------
    @on(m.MatchB)
    def _on_match_b(self, src: Address, msg: m.MatchB) -> None:
        if self._phase != "matchmaking" or msg.round != self.round:
            return
        self._match_acks[src] = msg
        if len(self._match_acks) < self.f + 1:
            return
        history: Dict[Round, Configuration] = {}
        gc_w: Any = NEG_INF
        for b in self._match_acks.values():
            gc_w = max_round(gc_w, b.gc_watermark)
            for j, cj in b.history:
                history[j] = cj
        self.history = {j: c for j, c in history.items() if not (j < gc_w)}
        self.oracle.on_matchmaking_complete(len(self.history))
        self._phase = "phase1"
        if not self.history:
            self._finish_phase1()
            return
        for c in self.history.values():
            self.broadcast(c.acceptors, m.Phase1A(round=self.round, from_slot=SLOT))

    # -- Phase 1 (Algorithm 3 lines 9-13) --------------------------------
    @on(m.Phase1B)
    def _on_phase1b(self, src: Address, msg: m.Phase1B) -> None:
        if self._phase != "phase1" or msg.round != self.round:
            return
        for cfg in self.history.values():
            if src in cfg.acceptors:
                self._p1_acks.setdefault(cfg.config_id, set()).add(src)
        for v in msg.votes:
            if v.slot != SLOT:
                continue
            if self._k == NEG_INF or self._k < v.vr:
                self._k, self._kv = v.vr, v.vv
                if self.round_pruning:
                    # Opt 4: configurations in rounds < vr no longer need to
                    # be intersected.
                    self._prune_floor = max_round(self._prune_floor, v.vr)
        self._maybe_finish_phase1()

    def _maybe_finish_phase1(self) -> None:
        for j, cfg in self.history.items():
            if self.round_pruning and j < self._prune_floor:
                continue  # pruned
            if not cfg.phase1.is_quorum(self._p1_acks.get(cfg.config_id, set())):
                return
        self._finish_phase1()

    def _finish_phase1(self) -> None:
        self._phase = "phase2"
        if self._k != NEG_INF:
            x = self._kv  # Algorithm 3 line 12
        else:
            x = self.value
            self.k_was_neg1 = True
            if self.gc_enabled:
                # GC Scenario 2: k = -1 -> nothing chosen below round i.
                self.broadcast(self.matchmakers, m.GarbageA(round=self.round))
        self._proposed = x
        self.broadcast(
            self.config.acceptors, m.Phase2A(round=self.round, slot=SLOT, value=x)
        )

    # -- Phase 2 (Algorithm 3 lines 14-15) -------------------------------
    @on(m.Phase2B)
    def _on_phase2b(self, src: Address, msg: m.Phase2B) -> None:
        if self._phase != "phase2" or msg.round != self.round:
            return
        self._p2_acks.add(src)
        if self.config.phase2.is_quorum(self._p2_acks):
            self.cmdlog.mark_chosen(SLOT, self._proposed)
            self._phase = "done"
            self.oracle.on_chosen(SLOT, self._proposed, self.round, self.now, self.addr)
            if self.gc_enabled:
                # GC Scenario 1: a value is chosen in round i.
                self.broadcast(self.matchmakers, m.GarbageA(round=self.round))
