"""Every protocol message, as an immutable dataclass.

Naming follows the paper: MatchA/MatchB (Matchmaking phase), Phase1A/Phase1B,
Phase2A/Phase2B, GarbageA/GarbageB (Section 5), StopA/StopB + Bootstrap
(matchmaker reconfiguration, Section 6).  Nacks are the "straightforward
details" the paper elides; they are required for liveness under our
simulated message drops and round races.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, FrozenSet, Mapping, Optional, Tuple

from .quorums import Configuration
from .rounds import Round

Address = str
Slot = int


# --------------------------------------------------------------------------
# Values (state machine commands)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Command:
    """A client command.  ``cmd_id`` provides at-most-once semantics."""

    cmd_id: Tuple[str, int]  # (client address, client sequence number)
    op: Any

    def __repr__(self) -> str:
        return f"Cmd({self.cmd_id[0]}#{self.cmd_id[1]})"


@dataclass(frozen=True)
class Noop:
    """The paper's no-op filler for log holes."""

    def __repr__(self) -> str:
        return "Noop"


NOOP = Noop()
ANY_VALUE = Command(("<any>", -1), None)  # Fast Paxos "any" (Algorithm 5)


# --------------------------------------------------------------------------
# Transport-level batching (paper Section 8: batched deployment)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Batch:
    """Hot-path messages to one destination coalesced into one wire
    message.  Unwrapped by the kernel dispatch loop (runtime.ProtocolNode)
    before handlers run, so batching never changes handler semantics."""

    messages: Tuple[Any, ...]

    def __repr__(self) -> str:
        return f"Batch[{len(self.messages)}]"


class SealedBatch:
    """A relay-safe batch envelope (the zero-copy router fast path).

    ``Batch`` shares one string-intern table across its sub-messages, so a
    relay cannot forward a *subset* of an encoded Batch without re-encoding
    (a back-reference may point at a string owned by a sub-message that
    stayed behind).  A SealedBatch instead encodes every sub-message as a
    self-contained length-prefixed sub-frame with its own intern scope:
    a router can split a received frame into per-shard onward frames by
    slicing the already-encoded bytes, never decoding the commands.

    Two construction modes:

      * ``SealedBatch(messages=...)`` — a sender-side envelope holding
        live message objects (the simulator path, and the encoder's
        slow path).
      * ``SealedBatch(raw=..., spans=...)`` — a decoded/relayed view:
        ``raw`` is the encoded payload buffer and ``spans`` the
        ``(start, end)`` byte range of each sub-frame.  ``messages``
        decodes lazily on first access, so a pure relay hop never pays
        for decoding command bodies.

    Receivers unwrap it exactly like ``Batch`` (kernel dispatch loop), so
    handler semantics are identical with either envelope.
    """

    __slots__ = ("_messages", "raw", "spans")

    def __init__(
        self,
        messages: Optional[Tuple[Any, ...]] = None,
        *,
        raw: Optional[bytes] = None,
        spans: Optional[Tuple[Tuple[int, int], ...]] = None,
    ):
        if messages is None and (raw is None or spans is None):
            raise ValueError("SealedBatch needs messages or raw+spans")
        self._messages = tuple(messages) if messages is not None else None
        self.raw = raw
        self.spans = tuple(spans) if spans is not None else None

    def __len__(self) -> int:
        if self.spans is not None:
            return len(self.spans)
        return len(self._messages)

    @property
    def messages(self) -> Tuple[Any, ...]:
        if self._messages is None:
            from . import wire  # lazy: messages must not import the codec

            self._messages = wire.sealed_messages(self.raw, self.spans)
        return self._messages

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, SealedBatch):
            return NotImplemented
        return self.messages == other.messages

    def __hash__(self) -> int:
        return hash(self.messages)

    def __repr__(self) -> str:
        return f"SealedBatch[{len(self)}]"


# --------------------------------------------------------------------------
# Client <-> proposer / replica
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ClientRequest:
    command: Command


@dataclass(frozen=True)
class ClientReply:
    cmd_id: Tuple[str, int]
    result: Any
    slot: Optional[Slot] = None


@dataclass(frozen=True)
class LeaderHint:
    """Redirect a client to the current leader."""

    leader: Address


# --------------------------------------------------------------------------
# Matchmaking phase (Algorithms 1 and 4)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MatchA:
    round: Round
    config: Configuration
    # Sharded log plane: matchmakers keep an independent (L, w) per shard
    # so every shard can run its Matchmaking phase against the *shared*
    # matchmaker set without round interference.  shard=0 is the
    # historical unsharded namespace.
    shard: int = 0


@dataclass(frozen=True)
class MatchB:
    round: Round
    gc_watermark: Any  # Round | NEG_INF — rounds < w are garbage collected
    history: Tuple[Tuple[Round, Configuration], ...]  # H_i = {(j, C_j) | j < i}


@dataclass(frozen=True)
class MatchNack:
    round: Round  # the offending round
    witnessed: Any  # a round >= ours that the matchmaker has seen


# --------------------------------------------------------------------------
# Phase 1 / Phase 2 (Algorithms 2 and 3, MultiPaxos-extended)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Phase1A:
    round: Round
    from_slot: Slot = 0  # MultiPaxos: only report votes at slots >= from_slot


@dataclass(frozen=True)
class PhaseVote:
    slot: Slot
    vr: Any  # Round | NEG_INF
    vv: Any  # Command | Noop


@dataclass(frozen=True)
class Phase1B:
    round: Round
    votes: Tuple[PhaseVote, ...]
    # Scenario 3 (Section 5.2): this acceptor knows slots < chosen_watermark
    # are chosen and stored on f+1 replicas.
    chosen_watermark: Slot = 0


@dataclass(frozen=True)
class Phase1Nack:
    round: Round
    witnessed: Any


@dataclass(frozen=True)
class Phase2A:
    round: Round
    slot: Slot
    value: Any


@dataclass(frozen=True)
class Phase2B:
    round: Round
    slot: Slot


@dataclass(frozen=True)
class Phase2Nack:
    round: Round
    slot: Slot
    witnessed: Any


# --------------------------------------------------------------------------
# Chosen / replication
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Chosen:
    slot: Slot
    value: Any


@dataclass(frozen=True)
class ReplicaAck:
    """Replica r has persisted all slots < watermark."""

    watermark: Slot


@dataclass(frozen=True)
class StoredWatermark:
    """Leader -> Phase 2 quorum of C_i: slots < watermark are chosen and
    stored on f+1 replicas (precondition for GC Scenario 3)."""

    round: Round
    watermark: Slot


@dataclass(frozen=True)
class StoredWatermarkAck:
    round: Round
    watermark: Slot


@dataclass(frozen=True)
class FillRequest:
    """Replica -> shard leaders: execution is blocked on a hole at
    ``slot`` (sharded log plane, Mencius-style skip).  The leader owning
    the slot noop-fills its stream up through it; everyone else ignores
    the request."""

    slot: Slot


@dataclass(frozen=True)
class RecoverA:
    """New leader asks replicas for their chosen prefix."""


@dataclass(frozen=True)
class RecoverB:
    watermark: Slot
    entries: Tuple[Tuple[Slot, Any], ...]  # chosen log entries


# --------------------------------------------------------------------------
# Garbage collection (Section 5, Algorithm 4)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class GarbageA:
    round: Round  # garbage collect all configurations in rounds < round
    shard: int = 0  # scoped to one shard's configuration log


@dataclass(frozen=True)
class GarbageB:
    round: Round


# --------------------------------------------------------------------------
# Matchmaker reconfiguration (Section 6)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class StopA:
    pass


# ``log`` / ``gc_watermark`` carry shard 0 (the historical fields);
# ``shard_logs`` carries every shard > 0 as (shard, entries, watermark)
# triples so a Section 6 handover moves the whole sharded state.
ShardLogSnapshot = Tuple[int, Tuple[Tuple[Round, Configuration], ...], Any]


@dataclass(frozen=True)
class StopB:
    log: Tuple[Tuple[Round, Configuration], ...]
    gc_watermark: Any
    shard_logs: Tuple[ShardLogSnapshot, ...] = ()


@dataclass(frozen=True)
class Bootstrap:
    log: Tuple[Tuple[Round, Configuration], ...]
    gc_watermark: Any
    shard_logs: Tuple[ShardLogSnapshot, ...] = ()


@dataclass(frozen=True)
class BootstrapAck:
    pass


@dataclass(frozen=True)
class MMEnable:
    """Sent once the new matchmaker set is *chosen*; enables processing."""


# Single-decree Paxos among the old matchmakers to choose the new set
# (Section 6: "every matchmaker in M_old doubles as a Paxos acceptor").
@dataclass(frozen=True)
class MMP1A:
    ballot: Round


@dataclass(frozen=True)
class MMP1B:
    ballot: Round
    vb: Any  # Round | NEG_INF
    vv: Any  # the matchmaker set voted for


@dataclass(frozen=True)
class MMP2A:
    ballot: Round
    value: Tuple[Address, ...]  # M_new


@dataclass(frozen=True)
class MMP2B:
    ballot: Round


@dataclass(frozen=True)
class MMNack:
    ballot: Round


@dataclass(frozen=True)
class SetMatchmakers:
    """Point a proposer at a new matchmaker set after a Section 6
    matchmaker reconfiguration completed.  In-process deployments use the
    coordinator's ``on_complete`` callback directly; multi-process
    deployments (the proc plane) deliver the same fact as a message."""

    matchmakers: Tuple[Address, ...]


# --------------------------------------------------------------------------
# Leader election / failure detection
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Heartbeat:
    round: Round


@dataclass(frozen=True)
class Ping:
    nonce: int


@dataclass(frozen=True)
class Pong:
    nonce: int


# --------------------------------------------------------------------------
# Fast Paxos (Section 7, Algorithm 5)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class FastP2A:
    """A fast-round proposal sent by *clients* directly to acceptors."""

    round: Round
    value: Any


@dataclass(frozen=True)
class FastP2B:
    round: Round
    value: Any
