"""Round numbers.

The paper (Section 3.4, Optimization 2) uses lexicographically ordered
triples ``(r, proposer_id, s)`` so that the proposer of round ``(r, p, s)``
always owns the *next* round ``(r, p, s+1)``.  Bumping ``s`` is how a stable
leader performs a reconfiguration (Phase-1 bypassing applies); bumping ``r``
is how a new leader takes over (full Phase 1 required).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import Optional


@total_ordering
@dataclass(frozen=True)
class Round:
    r: int
    proposer: int
    s: int

    def key(self):
        return (self.r, self.proposer, self.s)

    def __lt__(self, other: "Round") -> bool:
        if other is NEG_INF_SENTINEL:
            return False
        return self.key() < other.key()

    def __eq__(self, other) -> bool:
        return isinstance(other, Round) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def next_s(self) -> "Round":
        """The next round owned by the same proposer (reconfiguration)."""
        return Round(self.r, self.proposer, self.s + 1)

    def next_r(self, proposer: int) -> "Round":
        """A strictly larger round owned by ``proposer`` (takeover)."""
        return Round(self.r + 1, proposer, 0)

    def __repr__(self) -> str:  # compact for logs
        return f"({self.r},{self.proposer},{self.s})"


class _NegInf:
    """The ``-1`` round of the paper: smaller than every real round."""

    def __lt__(self, other) -> bool:
        return not isinstance(other, _NegInf)

    def __le__(self, other) -> bool:
        return True

    def __gt__(self, other) -> bool:
        return False

    def __ge__(self, other) -> bool:
        return isinstance(other, _NegInf)

    def __eq__(self, other) -> bool:
        return isinstance(other, _NegInf)

    def __hash__(self) -> int:
        return hash("NEG_INF_ROUND")

    def __repr__(self) -> str:
        return "(-inf)"


NEG_INF_SENTINEL = _NegInf()
NEG_INF = NEG_INF_SENTINEL


def max_round(a, b):
    return a if b <= a else b


def initial_round(proposer: int) -> Round:
    return Round(0, proposer, 0)
