"""Flexible Paxos configurations (Section 2.3).

A configuration ``C = (A; P1; P2)`` is a set of acceptors plus Phase-1 and
Phase-2 quorum systems such that every P1 quorum intersects every P2 quorum.
The paper's protocols are stated over arbitrary configurations; the common
case is majority quorums over ``2f+1`` acceptors.  The Fast Paxos variant
(Section 7) uses ``f+1`` acceptors with singleton P1 quorums and a single
unanimous P2 quorum.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import FrozenSet, Iterable, List, Sequence, Tuple

Address = str


@dataclass(frozen=True)
class QuorumSpec:
    """A threshold-or-explicit quorum system over a fixed acceptor set."""

    members: Tuple[Address, ...]
    threshold: int = 0  # any subset of size >= threshold is a quorum
    explicit: Tuple[FrozenSet[Address], ...] = ()  # or an explicit list

    def is_quorum(self, acks: Iterable[Address]) -> bool:
        acks = frozenset(acks) & frozenset(self.members)
        if self.explicit:
            return any(q <= acks for q in self.explicit)
        return len(acks) >= self.threshold

    def sample(self, rng: random.Random) -> Tuple[Address, ...]:
        """A single quorum — used by the thriftiness optimization."""
        if self.explicit:
            return tuple(sorted(rng.choice(self.explicit)))
        return tuple(sorted(rng.sample(list(self.members), self.threshold)))

    def min_size(self) -> int:
        if self.explicit:
            return min(len(q) for q in self.explicit)
        return self.threshold


@dataclass(frozen=True)
class Configuration:
    """``C = (A; P1; P2)`` with a unique id for telemetry and GC tracking."""

    config_id: int
    acceptors: Tuple[Address, ...]
    phase1: QuorumSpec
    phase2: QuorumSpec

    @staticmethod
    def majority(config_id: int, acceptors: Sequence[Address]) -> "Configuration":
        n = len(acceptors)
        maj = n // 2 + 1
        acc = tuple(acceptors)
        return Configuration(
            config_id=config_id,
            acceptors=acc,
            phase1=QuorumSpec(acc, threshold=maj),
            phase2=QuorumSpec(acc, threshold=maj),
        )

    @staticmethod
    def flexible(
        config_id: int, acceptors: Sequence[Address], p1: int, p2: int
    ) -> "Configuration":
        """Threshold Flexible Paxos: requires p1 + p2 > |A|."""
        acc = tuple(acceptors)
        assert p1 + p2 > len(acc), "P1/P2 quorums must intersect"
        return Configuration(
            config_id=config_id,
            acceptors=acc,
            phase1=QuorumSpec(acc, threshold=p1),
            phase2=QuorumSpec(acc, threshold=p2),
        )

    @staticmethod
    def fast_f_plus_1(config_id: int, acceptors: Sequence[Address]) -> "Configuration":
        """Section 7: f+1 acceptors, singleton P1 quorums, unanimous P2."""
        acc = tuple(acceptors)
        singletons = tuple(frozenset({a}) for a in acc)
        return Configuration(
            config_id=config_id,
            acceptors=acc,
            phase1=QuorumSpec(acc, explicit=singletons),
            phase2=QuorumSpec(acc, threshold=len(acc)),
        )

    @staticmethod
    def grid(config_id: int, rows: Sequence[Sequence[Address]]) -> "Configuration":
        """Grid quorums: P1 = any full row, P2 = any full column."""
        n_rows = len(rows)
        n_cols = len(rows[0])
        acc = tuple(a for row in rows for a in row)
        p1 = tuple(frozenset(row) for row in rows)
        p2 = tuple(
            frozenset(rows[r][c] for r in range(n_rows)) for c in range(n_cols)
        )
        return Configuration(
            config_id=config_id,
            acceptors=acc,
            phase1=QuorumSpec(acc, explicit=p1),
            phase2=QuorumSpec(acc, explicit=p2),
        )

    def validate_intersection(self) -> bool:
        """Exhaustively check P1 x P2 intersection (tests only; small n)."""

        def quorums(spec: QuorumSpec):
            if spec.explicit:
                return list(spec.explicit)
            return [
                frozenset(c)
                for c in itertools.combinations(spec.members, spec.threshold)
            ]

        return all(
            q1 & q2 for q1 in quorums(self.phase1) for q2 in quorums(self.phase2)
        )

    def __repr__(self) -> str:
        return f"C{self.config_id}{list(self.acceptors)}"
