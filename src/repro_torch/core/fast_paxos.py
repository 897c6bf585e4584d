"""Matchmaker Fast Paxos (Section 7, Algorithm 5).

The theoretical headline of Section 7: with matchmakers, Fast Paxos can be
deployed with a *fixed set of f+1 acceptors* — singleton Phase 1 quorums and
a single unanimous Phase 2 quorum — hitting the lower bound on quorum size.

The flow: the coordinator runs the Matchmaking phase and Phase 1 as usual.
If ``k = -1`` or the vote set ``V`` at round ``k`` contains multiple distinct
values, it issues ``Phase2A(i, any)``; acceptors then vote for the *first
client value* they receive in round ``i`` (clients broadcast values directly
to the acceptors — the fast path that saves a message delay).  A value is
chosen when all f+1 acceptors vote for it.  Conflicts are recovered by the
coordinator starting a higher round.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from . import messages as m
from .oracle import Oracle
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import on
from .sim import Address, Node

SLOT = 0


class FastAcceptor(Node):
    """A Fast Paxos acceptor.  Identical to Algorithm 2 plus the "any" rule:
    after ``Phase2A(i, any)`` it votes for the first client value of round i.
    """

    def __init__(self, addr: Address, *, learners: Tuple[Address, ...] = ()):
        super().__init__(addr)
        self.round: Any = NEG_INF
        self.vr: Any = NEG_INF
        self.vv: Any = None
        self.any_round: Any = NEG_INF  # round in which "any" is active
        self.learners = learners

    @on(m.Phase1A)
    def _on_phase1a(self, src: Address, msg: m.Phase1A) -> None:
        if msg.round < self.round:
            self.send(src, m.Phase1Nack(round=msg.round, witnessed=self.round))
            return
        self.round = msg.round
        votes = ()
        if self.vr != NEG_INF:
            votes = (m.PhaseVote(slot=SLOT, vr=self.vr, vv=self.vv),)
        self.send(src, m.Phase1B(round=msg.round, votes=votes))

    @on(m.Phase2A)
    def _on_phase2a(self, src: Address, msg: m.Phase2A) -> None:
        if msg.round < self.round:
            self.send(
                src, m.Phase2Nack(round=msg.round, slot=SLOT, witnessed=self.round)
            )
            return
        self.round = msg.round
        if msg.value is m.ANY_VALUE or (
            isinstance(msg.value, m.Command) and msg.value.cmd_id == m.ANY_VALUE.cmd_id
        ):
            # Enable the fast path for this round; do not vote yet.
            self.any_round = max_round(self.any_round, msg.round)
            # If a client value is already buffered, nothing to do: the
            # fast path only applies to values arriving afterwards
            # (buffering both ways is an optimization we skip).
        else:
            self._vote(msg.round, msg.value)

    @on(m.FastP2A)
    def _on_fast_p2a(self, src: Address, msg: m.FastP2A) -> None:
        # A client value for the fast path.  Vote iff round i is
        # fast-enabled, we haven't voted in i yet, and i >= r.
        i = self.any_round
        if i == NEG_INF or i < self.round:
            return
        if self.vr == i:
            return  # already voted in this round: first value wins
        self._vote(i, msg.value)

    def _vote(self, rnd: Round, value: Any) -> None:
        self.round = rnd
        self.vr = rnd
        self.vv = value
        for l in self.learners:
            self.send(l, m.FastP2B(round=rnd, value=value))


class FastCoordinator(Node):
    """Algorithm 5 — the proposer/coordinator/learner."""

    def __init__(
        self,
        addr: Address,
        proposer_id: int,
        *,
        matchmakers: Tuple[Address, ...],
        oracle: Oracle,
        config_provider: Callable[[int], Configuration],
        f: int = 1,
        max_attempts: int = 50,
        recovery_backoff: float = 0.05,
    ):
        super().__init__(addr)
        self.pid = proposer_id
        self.matchmakers = matchmakers
        self.oracle = oracle
        self.config_provider = config_provider
        self.f = f
        self.max_attempts = max_attempts
        self.recovery_backoff = recovery_backoff

        self.round: Optional[Round] = None
        self.config: Optional[Configuration] = None
        self.history: Dict[Round, Configuration] = {}
        self.attempt = 0
        self.max_witnessed: Any = NEG_INF
        self._match_acks: Dict[Address, m.MatchB] = {}
        self._p1_acks: Dict[int, Set[Address]] = {}
        self._p1_votes: List[Tuple[Any, Any]] = []  # (vr, vv)
        self._fast_votes: Dict[Round, Dict[Address, Any]] = {}
        self._round_configs: Dict[Round, Configuration] = {}
        self._phase = "idle"
        self.chosen_value: Any = None

    # ------------------------------------------------------------------
    def start_round(self) -> None:
        if self.chosen_value is not None:
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
        self._round_configs[self.round] = self.config
        self._match_acks = {}
        self._p1_acks = {}
        self._p1_votes = []
        self._phase = "matchmaking"
        self.broadcast(self.matchmakers, m.MatchA(round=self.round, config=self.config))
        rnd = self.round
        self.set_timer(
            self.recovery_backoff * (2 + 0.3 * self.pid),
            lambda: self._recover_if_stuck(rnd),
        )

    def _recover_if_stuck(self, rnd: Round) -> None:
        """Conflict/stall recovery: move to a higher round."""
        if self.chosen_value is None and self.round == rnd:
            self.start_round()

    # ------------------------------------------------------------------
    @on(m.MatchNack, m.Phase1Nack)
    def _on_any_nack(self, src: Address, msg: Any) -> None:
        if isinstance(msg.witnessed, Round):
            self.max_witnessed = max_round(self.max_witnessed, msg.witnessed)

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
        self._phase = "phase1"
        if not self.history:
            self._finish_phase1()
            return
        for c in self.history.values():
            self.broadcast(c.acceptors, m.Phase1A(round=self.round, from_slot=SLOT))

    @on(m.Phase1B)
    def _on_phase1b(self, src: Address, msg: m.Phase1B) -> None:
        if self._phase != "phase1" or msg.round != self.round:
            return
        for cfg in self.history.values():
            if src in cfg.acceptors:
                self._p1_acks.setdefault(cfg.config_id, set()).add(src)
        for v in msg.votes:
            self._p1_votes.append((v.vr, v.vv))
        for cfg in self.history.values():
            if not cfg.phase1.is_quorum(self._p1_acks.get(cfg.config_id, set())):
                return
        self._finish_phase1()

    def _finish_phase1(self) -> None:
        """Algorithm 5 lines 8-15."""
        self._phase = "phase2"
        k: Any = NEG_INF
        for vr, _ in self._p1_votes:
            k = max_round(k, vr)
        if k == NEG_INF:
            proposal = m.ANY_VALUE  # line 11: "any"
        else:
            V = {repr(vv): vv for vr, vv in self._p1_votes if vr == k}
            if len(V) == 1:
                proposal = next(iter(V.values()))  # line 13
            else:
                proposal = m.ANY_VALUE  # line 15
        self.broadcast(
            self.config.acceptors,
            m.Phase2A(round=self.round, slot=SLOT, value=proposal),
        )

    @on(m.FastP2B)
    def _on_fast_p2b(self, src: Address, msg: m.FastP2B) -> None:
        votes = self._fast_votes.setdefault(msg.round, {})
        votes[src] = msg.value
        cfg = self._round_configs.get(msg.round)
        if cfg is None:
            return
        # Unanimous Phase 2 quorum: all f+1 acceptors vote the same value.
        # Checked for *every* round (not just the current one) so the safety
        # oracle observes chosen values even after the coordinator moved on.
        if len(votes) == len(cfg.acceptors):
            values = {repr(v): v for v in votes.values()}
            if len(values) == 1:
                value = next(iter(values.values()))
                self.oracle.on_chosen(SLOT, value, msg.round, self.now, self.addr)
                if self.chosen_value is None:
                    self.chosen_value = value
            # else: conflict — the recovery timer will start a higher round.


class FastClient(Node):
    """A Fast Paxos client: broadcasts its value directly to the acceptors."""

    def __init__(self, addr: Address, acceptors: Tuple[Address, ...], value: Any):
        super().__init__(addr)
        self.acceptors = acceptors
        self.value = value

    def propose(self) -> None:
        for a in self.acceptors:
            self.send(a, m.FastP2A(round=None, value=self.value))
