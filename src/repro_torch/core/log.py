"""The slot-ownership layer: log bookkeeping shared by every role.

Matchmaker MultiPaxos (Section 4) implicitly assumes one proposer owns
the whole log: ``next_slot`` is a plain counter, the chosen watermark is
"slots < w are chosen", and Phase 1 re-proposes every slot in a range.
This module makes the ownership assumption *explicit* so it can be
changed: a :class:`SlotOwnership` is a stride partition of the slot space
(``slot = shard_id + k * num_shards``, the Mencius/BPaxos round-robin
scheme), and every piece of log bookkeeping that was welded into the
proposer — the slot map, the chosen watermark, replica-ack tracking —
consults it instead of assuming ownership of all of ℕ.

With ``num_shards == 1`` every operation below degenerates to exactly the
historical single-leader arithmetic (``first_owned(s) == s``,
``claim()`` increments by one), which is what keeps the sharded log plane
byte-for-byte behavior-compatible with the seed deployment.

Consumers:

  * ``Proposer`` — :class:`CommandLog` (claiming, Phase-1 re-proposal
    ranges, watermark advance over owned slots) + :class:`AckTracker`
    (replica replication watermark for GC Scenario 3);
  * ``SingleDecreeProposer`` — a one-slot :class:`CommandLog`;
  * ``HorizontalProposer`` — a :class:`CommandLog` plus its alpha window;
  * ``Replica`` — :class:`ExecutionLog`: in-order execution over the
    *interleaved* shard streams, with per-shard frontier telemetry (the
    pipelined-execution view: each shard's stream may run ahead of the
    contiguous execution watermark independently).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

Address = str


# --------------------------------------------------------------------------
# Ownership policy
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SlotOwnership:
    """Stride partition of the slot space: shard ``s`` of ``n`` owns
    ``{s + k*n | k >= 0}``.  The partition is disjoint and covering by
    construction (tests/core/test_properties.py proves it property-based).
    ``SlotOwnership(0, 1)`` owns everything — the single-leader case."""

    shard_id: int = 0
    num_shards: int = 1

    def __post_init__(self) -> None:
        assert self.num_shards >= 1, "num_shards must be >= 1"
        assert 0 <= self.shard_id < self.num_shards, (
            f"shard_id {self.shard_id} outside [0, {self.num_shards})"
        )

    @classmethod
    def all(cls) -> "SlotOwnership":
        return cls(0, 1)

    def owns(self, slot: int) -> bool:
        return slot % self.num_shards == self.shard_id

    def first_owned(self, from_slot: int) -> int:
        """Smallest owned slot >= ``from_slot`` (identity when unsharded)."""
        r = (self.shard_id - from_slot) % self.num_shards
        return from_slot + r

    def owned_range(self, lo: int, hi: int) -> range:
        """Owned slots in [lo, hi) — the Phase-1 re-proposal iteration."""
        return range(self.first_owned(lo), hi, self.num_shards)

    def index_of(self, slot: int) -> int:
        """The k with ``slot = shard_id + k*num_shards`` (owned slots only)."""
        assert self.owns(slot), f"slot {slot} not owned by {self}"
        return (slot - self.shard_id) // self.num_shards

    def slot_at(self, index: int) -> int:
        return self.shard_id + index * self.num_shards


def shard_of_slot(slot: int, num_shards: int) -> int:
    """Which shard owns ``slot`` under the stride policy."""
    return slot % max(1, num_shards)


# --------------------------------------------------------------------------
# Proposer-side bookkeeping
# --------------------------------------------------------------------------
@dataclass
class SlotState:
    """One in-flight (or chosen) log entry at the proposer."""

    value: Any
    round: Any
    config: Any
    acks: Set[Address] = field(default_factory=set)
    chosen: bool = False
    is_reproposal: bool = False


class CommandLog:
    """The leader's view of (its share of) the log.

    ``slots`` maps slot -> :class:`SlotState` for proposals in flight;
    ``chosen_values`` is the learned chosen log; ``chosen_watermark`` is
    ownership-aware: every *owned* slot below it is chosen (for the
    unsharded case this is exactly the historical contiguous prefix).
    ``next_slot`` is the next slot this leader may claim and is always
    owned-aligned.
    """

    def __init__(self, ownership: Optional[SlotOwnership] = None):
        self.ownership = ownership or SlotOwnership.all()
        self.slots: Dict[int, SlotState] = {}
        self.chosen_values: Dict[int, Any] = {}
        self.chosen_watermark = 0
        self.next_slot = self.ownership.first_owned(0)

    # -- claiming ----------------------------------------------------------
    def claim(self) -> int:
        """Claim the next owned slot for a fresh proposal."""
        slot = self.next_slot
        self.next_slot += self.ownership.num_shards
        return slot

    def note_seen(self, slot: int) -> None:
        """Advance ``next_slot`` past an externally-learned slot (a Chosen
        broadcast, a recovered entry) without claiming anything."""
        if slot >= self.next_slot:
            self.next_slot = self.ownership.first_owned(slot + 1)

    def raise_horizon(self, slot: int) -> None:
        """Ensure ``next_slot`` is at least the owned slot >= ``slot``
        (Phase-1 horizon bump)."""
        aligned = self.ownership.first_owned(slot)
        if aligned > self.next_slot:
            self.next_slot = aligned

    # -- chosen tracking ---------------------------------------------------
    def mark_chosen(self, slot: int, value: Any) -> None:
        self.chosen_values[slot] = value
        self.advance_watermark()

    def advance_watermark(self) -> None:
        """Ownership-aware contiguity: bump past every owned chosen slot.
        Unsharded, this is the historical ``while w in chosen: w += 1``."""
        w = self.chosen_watermark
        while True:
            s = self.ownership.first_owned(w)
            if s in self.chosen_values:
                w = s + 1
            else:
                break
        self.chosen_watermark = w

    # -- Phase 1 surfaces --------------------------------------------------
    def reproposal_range(self, floor: int, horizon: int) -> range:
        """The slots a recovering leader must resolve: *owned* slots in
        [floor, horizon).  A shard leader must never propose (even a noop)
        in a slot another shard owns — that slot's value is decided by a
        different acceptor group, and filling it here would be a
        double-choose."""
        return self.ownership.owned_range(floor, horizon)

    def in_flight(self) -> int:
        """Claimed-but-unchosen owned slots (the alpha-window count),
        measured in *owned* slots so the window means the same thing at
        every shard count."""
        claimed = self.ownership.owned_range(self.chosen_watermark, self.next_slot)
        return len(claimed)


class AckTracker:
    """Replica replication-watermark tracking (GC Scenario 3): the
    ``need``-th highest acked watermark is on >= ``need`` replicas."""

    def __init__(self) -> None:
        self.acks: Dict[Address, int] = {}
        self.watermark = 0

    def observe(self, addr: Address, watermark: int) -> None:
        self.acks[addr] = max(self.acks.get(addr, 0), watermark)

    def quorum_watermark(self, need: int) -> int:
        marks = sorted(self.acks.values(), reverse=True)
        if len(marks) >= need:
            self.watermark = max(self.watermark, marks[need - 1])
        return self.watermark


# --------------------------------------------------------------------------
# Replica-side bookkeeping
# --------------------------------------------------------------------------
class ExecutionLog:
    """The replica's chosen log + in-order execution watermark.

    Entries arrive as *interleaved shard streams* — each shard's leader
    broadcasts Chosen for its owned slots independently, so the log fills
    with per-shard holes.  Execution stays strictly slot-ordered: values
    become executable only when the contiguous prefix reaches them, which
    is what makes replica output order invariant under any interleaving
    of the shard streams (tests/core/test_properties.py).

    ``num_shards`` is telemetry-only (per-shard frontiers / backlog); it
    never affects execution order.
    """

    def __init__(self, num_shards: int = 1):
        self.entries: Dict[int, Any] = {}
        self.watermark = 0  # slots < this executed
        self.max_slot = -1  # highest slot ever inserted (frontier)
        self.num_shards = max(1, num_shards)
        # Per-shard chosen frontier, maintained incrementally on insert so
        # telemetry reads are O(num_shards), never O(entries).
        self._frontiers: Dict[int, int] = {}

    def insert(self, slot: int, value: Any) -> Optional[Any]:
        """Record a chosen value.  Returns the previous value if the slot
        was already filled (caller asserts consistency), else None."""
        prev = self.entries.get(slot)
        self.entries[slot] = value
        if slot > self.max_slot:
            self.max_slot = slot
        if prev is None:
            s = slot % self.num_shards
            if slot >= self._frontiers.get(s, 0):
                self._frontiers[s] = slot + 1
        return prev

    def drain_executable(self) -> List[Tuple[int, Any]]:
        """Pop the contiguous run starting at the watermark, in order."""
        out: List[Tuple[int, Any]] = []
        while self.watermark in self.entries:
            out.append((self.watermark, self.entries[self.watermark]))
            self.watermark += 1
        return out

    # -- pipelined-execution telemetry ------------------------------------
    def shard_frontiers(self) -> Dict[int, int]:
        """Per-shard highest chosen slot + 1 (how far each stream ran).
        Incremental (updated in :meth:`insert`), so surfacing it per run
        summary costs O(num_shards)."""
        return dict(self._frontiers)

    def cursor_lag(self) -> Dict[int, int]:
        """Per-shard execution-cursor lag: how far each shard's chosen
        stream ran *ahead* of the contiguous execution watermark.  A shard
        with lag 0 while the others pile up is the slow stream stalling
        the slot-order execution loop."""
        w = self.watermark
        return {s: max(0, f - w) for s, f in self._frontiers.items()}

    def backlog(self) -> int:
        """Chosen-but-not-executable entries (blocked on another shard's
        hole) — the pipelining depth.  O(1): entries is append-only and
        every slot below the watermark is present by construction."""
        return len(self.entries) - self.watermark
