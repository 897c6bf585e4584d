"""The acceptor role (Algorithm 2, extended per-slot for MultiPaxos).

Identical to a Paxos acceptor: a largest-seen round ``r`` plus, per log
slot, the largest round voted in and the value voted for.  The MultiPaxos
extension follows Section 4.1: one ``Phase1A(i)`` acts as the Phase 1
message for every slot >= ``from_slot``; the acceptor replies only with the
slots it has actually voted in.

The ``chosen_watermark`` is the Scenario-3 machinery of Section 5: once the
leader tells a Phase 2 quorum that all slots < w are chosen and stored on
f+1 replicas, any future leader intersecting that quorum learns it may fetch
the prefix from the replicas instead of re-proposing it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from . import messages as m
from .rounds import NEG_INF, Round
from .runtime import BatchPolicy, on
from .sim import Address, Node


class Acceptor(Node):
    def __init__(self, addr: Address, *, batch: Optional[BatchPolicy] = None):
        super().__init__(addr, batch=batch)
        self.round: Any = NEG_INF  # largest seen round r
        self.votes: Dict[int, Tuple[Any, Any]] = {}  # slot -> (vr, vv)
        self.chosen_watermark: int = 0  # Scenario 3 (Section 5.2)
        # telemetry
        self.phase1_count = 0
        self.phase2_count = 0

    # -- durability (proc plane) -------------------------------------------
    # The paper's crash-recovery model: an acceptor's promise, votes and
    # chosen watermark are persisted synchronously *before* any reply
    # leaves the process (the proc plane's worker host enforces the
    # before-send ordering); a restarted process reloads them and answers
    # exactly as if it had only been slow.
    def persistent_state(self) -> Dict[str, Any]:
        return {
            "round": self.round,
            "votes": dict(self.votes),
            "chosen_watermark": self.chosen_watermark,
        }

    def load_persistent_state(self, state: Dict[str, Any]) -> None:
        self.round = state["round"]
        self.votes = dict(state["votes"])
        self.chosen_watermark = state["chosen_watermark"]

    @on(m.StoredWatermark)
    def _on_stored_watermark(self, src: Address, msg: m.StoredWatermark) -> None:
        if msg.round >= self.round:
            self.chosen_watermark = max(self.chosen_watermark, msg.watermark)
            self.send(
                src,
                m.StoredWatermarkAck(round=msg.round, watermark=self.chosen_watermark),
            )

    @on(m.Ping)
    def _on_ping(self, src: Address, msg: m.Ping) -> None:
        self.send(src, m.Pong(msg.nonce))

    @on(m.Phase1A)
    def _on_phase1a(self, src: Address, msg: m.Phase1A) -> None:
        i = msg.round
        # "upon receiving Phase1A(i) from p with i > r" — re-promising the
        # same round is harmless and needed for retransmission liveness.
        if i < self.round:
            self.send(src, m.Phase1Nack(round=i, witnessed=self.round))
            return
        self.round = i
        self.phase1_count += 1
        votes = tuple(
            m.PhaseVote(slot=s, vr=vr, vv=vv)
            for s, (vr, vv) in sorted(self.votes.items())
            if s >= msg.from_slot
        )
        self.send(
            src,
            m.Phase1B(round=i, votes=votes, chosen_watermark=self.chosen_watermark),
        )

    @on(m.Phase2A)
    def _on_phase2a(self, src: Address, msg: m.Phase2A) -> None:
        i = msg.round
        # "upon receiving Phase2A(i, x) from p with i >= r"
        if i < self.round:
            self.send(src, m.Phase2Nack(round=i, slot=msg.slot, witnessed=self.round))
            return
        self.round = i
        self.votes[msg.slot] = (i, msg.value)
        self.phase2_count += 1
        self.send(src, m.Phase2B(round=i, slot=msg.slot))
