"""The protocol kernel: typed dispatch, effects, transports, batching.

This module is the narrow waist between *protocol logic* and *I/O*.  Every
role in the reproduction (``Proposer``, ``Acceptor``, ``Matchmaker``,
``Replica``, ``Client``, the single-decree and Fast Paxos variants, the
horizontal baseline and the matchmaker-reconfiguration coordinator) is a
``ProtocolNode``: a state machine whose handlers are registered with the
typed ``@on(MessageType)`` decorator and whose only way of affecting the
world is emitting :class:`Effect` objects through a :class:`Transport`.

Two transports interpret the effects:

  * ``sim.Simulator`` — the deterministic discrete-event network used by
    every test, oracle check and paper-figure benchmark; and
  * ``net.AsyncTransport`` — an in-process ``asyncio`` runtime that runs
    the *same unmodified* role classes over real event-loop scheduling.

Because protocol state machines never touch the event loop directly, a
future TCP/UDP transport is a transport-only patch.

Hot-path batching (the paper's Section 8 deployment batches commands) is
implemented here once, below the role classes and above the transports:
a ``BatchPolicy`` coalesces designated message types per destination into
``messages.Batch`` envelopes, flushed on a max-batch or flush-interval
trigger.  Receivers unwrap batches in the kernel dispatch loop, so every
handler observes the exact same per-message semantics with or without
batching (at-most-once is preserved under duplication and reordering).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Protocol,
    Tuple,
    Type,
    runtime_checkable,
)

from . import messages as m

Address = str


# --------------------------------------------------------------------------
# Effects
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Send:
    """Deliver ``msg`` to ``dst`` (asynchronously, unreliably)."""

    dst: Address
    msg: Any


@dataclass(frozen=True)
class Broadcast:
    """Deliver ``msg`` to every address in ``dsts`` (in order)."""

    dsts: Tuple[Address, ...]
    msg: Any


@dataclass(frozen=True)
class SetTimer:
    """Invoke ``callback`` after ``delay`` seconds of transport time."""

    delay: float
    callback: Callable[[], None]


@dataclass(frozen=True)
class CancelTimer:
    handle: Any


Effect = Any  # Send | Broadcast | SetTimer | CancelTimer


@runtime_checkable
class TimerHandle(Protocol):
    def cancel(self) -> None: ...


@runtime_checkable
class Transport(Protocol):
    """What a protocol node may observe of the outside world.

    ``now`` is the transport's monotonic clock (simulated or wall);
    ``rng`` is the transport's seeded randomness source (used e.g. by the
    thriftiness optimization to sample Phase 2 quorums); ``perform``
    interprets one effect on behalf of ``src`` and returns a
    :class:`TimerHandle` for ``SetTimer`` effects.
    """

    rng: random.Random

    @property
    def now(self) -> float: ...

    def register(self, node: "ProtocolNode") -> "ProtocolNode": ...

    def perform(self, src: Address, effect: Effect) -> Optional[TimerHandle]: ...


# --------------------------------------------------------------------------
# Typed handler registry
# --------------------------------------------------------------------------
def on(*msg_types: Type[Any]) -> Callable:
    """Register a method as the handler for one or more message types.

    Usage::

        class Proposer(ProtocolNode):
            @on(m.MatchB)
            def _on_match_b(self, src, msg): ...

    The per-class dispatch table is assembled at class-creation time by
    ``ProtocolNode.__init_subclass__``; subclasses inherit and may override
    handlers (latest definition in the MRO wins, like normal methods).
    """

    def deco(fn: Callable) -> Callable:
        fn._handles = tuple(msg_types)
        return fn

    return deco


class ProtocolNode:
    """Base class for protocol roles: pure state machine + effect emitter.

    Subclasses declare message handlers with ``@on(MsgType)``; inbound
    messages are dispatched through the generated per-class table (no
    ``isinstance`` chains).  Outbound I/O goes through ``send`` /
    ``broadcast`` / ``set_timer``, each of which emits an effect through
    the attached :class:`Transport`.  A node never observes global state.
    """

    _dispatch_names: Dict[type, str] = {}

    def __init_subclass__(cls, **kw) -> None:
        super().__init_subclass__(**kw)
        table: Dict[type, str] = {}
        for klass in reversed(cls.__mro__):
            for name, attr in vars(klass).items():
                for t in getattr(attr, "_handles", ()):
                    table[t] = name
        cls._dispatch_names = table

    def __init__(self, addr: Address, *, batch: Optional["BatchPolicy"] = None):
        self.addr = addr
        self.failed = False
        self.transport: Optional[Transport] = None
        self._handlers: Dict[type, Callable[[Address, Any], None]] = {
            t: getattr(self, name) for t, name in self._dispatch_names.items()
        }
        # A role that registers its own SealedBatch handler (the
        # ShardRouter's zero-copy relay) must see the *envelope*, not the
        # unwrapped sub-messages; resolve that once so the dispatch hot
        # path stays a type check.
        _sealed = self._handlers.get(m.SealedBatch)
        self._sealed_override = (
            _sealed
            if _sealed is not None
            and getattr(_sealed, "__func__", None) is not ProtocolNode._on_batch
            else None
        )
        self.batch = batch if batch is not None and batch.enabled else None
        self._batch_buf: Dict[Address, List[Any]] = {}
        self._batch_timer: Optional[TimerHandle] = None
        self._batch_first_at: Optional[float] = None  # adaptive-flush debounce
        # Incremented on every crash(); transports capture it when a timer
        # is armed and refuse to fire timers from a previous life, so a
        # restarted node never runs pre-crash timer chains alongside the
        # ones on_restart re-arms.
        self.life_epoch = 0
        # telemetry
        self.unhandled_count = 0
        self.batches_sent = 0
        self.crash_count = 0
        self.restart_count = 0

    # -- lifecycle ---------------------------------------------------------
    def on_start(self) -> None:  # pragma: no cover - default no-op
        pass

    def fail(self) -> None:
        self.failed = True
        # A crashed node's buffered (unsent) messages are lost with it.
        # The flush timer must be dropped too: transports suppress timer
        # callbacks while a node is failed, so a stale handle would keep
        # `_buffer` from ever re-arming flushing after recover().
        self._batch_buf.clear()
        self._batch_first_at = None
        if self._batch_timer is not None:
            self._batch_timer.cancel()
            self._batch_timer = None

    def recover(self) -> None:
        self.failed = False

    # -- crash / restart (nemesis fault model) -----------------------------
    def crash(self, *, clean: bool = False) -> None:
        """Crash this node.

        ``clean=True`` models an orderly shutdown (SIGTERM): buffered
        hot-path batches are flushed onto the wire before the process
        dies.  ``clean=False`` models ``kill -9``: in-flight effects that
        were only buffered in process memory are lost with the process.
        Either way the node stops sending, receiving and firing timers
        until :meth:`restart`.
        """
        if self.failed:
            return
        if clean:
            self.flush_batches()
        self.fail()
        self.life_epoch += 1  # every timer armed before this instant is dead
        self.crash_count += 1

    def restart(self, *, wipe_volatile: bool = True) -> None:
        """Restart a crashed node from its persisted state.

        Paxos roles persist their promises/votes/logs synchronously
        before answering (the paper's crash-recovery assumption), so
        those fields survive; ``wipe_volatile=True`` additionally drops
        whatever a real process keeps only in memory (see each role's
        :meth:`reset_volatile`).  A restarted node is live again and
        ``on_restart`` lets roles re-arm their timers.
        """
        if wipe_volatile:
            self.reset_volatile()
        self.recover()
        self.restart_count += 1
        self.on_restart()

    def reset_volatile(self) -> None:  # pragma: no cover - default no-op
        """Drop state a real process would lose on kill -9 (overridden by
        roles with volatile state, e.g. a proposer's leadership)."""

    def on_restart(self) -> None:  # pragma: no cover - default no-op
        """Hook for re-arming timers after a restart."""

    def mc_state(self) -> Dict[Any, Any]:
        """The node state a model-checker fingerprint must capture: every
        attribute that can influence the node's future behaviour (the
        verification plane, core/mc.py).  Defaults to the role's durable
        state; roles whose *volatile* state steers the protocol (a
        proposer's phase, a coordinator's pending acks) override this to
        include it.  Values must round-trip through the canonical value
        codec (``wire.encode_canonical``)."""
        ps = getattr(self, "persistent_state", None)
        return ps() if callable(ps) else {}

    # -- dispatch ----------------------------------------------------------
    def on_message(self, src: Address, msg: Any) -> None:
        # Hot path: one dict probe per message, and Batch envelopes unwrap
        # in-line (no re-entry through on_message per sub-message) — the
        # dominant receive shape of the batched Section 8 deployment.
        handlers = self._handlers
        t = type(msg)
        if t is m.Batch or t is m.SealedBatch:
            if t is m.SealedBatch and self._sealed_override is not None:
                self._sealed_override(src, msg)
                return
            for sub in msg.messages:
                handler = handlers.get(type(sub))
                if handler is None:
                    self.unhandled_count += 1
                else:
                    handler(src, sub)
            return
        handler = handlers.get(t)
        if handler is None:
            self.unhandled_count += 1
            return
        handler(src, msg)

    @on(m.Batch, m.SealedBatch)
    def _on_batch(self, src: Address, batch: Any) -> None:
        """Unwrap a batch envelope (plain or sealed): handlers see
        per-message semantics.  (Kept registered for subclasses that
        dispatch through the table directly; ``on_message`` takes the
        in-line fast path.)"""
        for sub in batch.messages:
            self.on_message(src, sub)

    # -- effect emission ---------------------------------------------------
    def emit(self, effect: Effect) -> Optional[TimerHandle]:
        return self.transport.perform(self.addr, effect)

    def send(self, dst: Address, msg: Any) -> None:
        if self.batch is not None and type(msg) in self.batch.batchable_set:
            self._buffer(dst, msg)
            return
        self.emit(Send(dst=dst, msg=msg))

    def broadcast(self, dsts: Iterable[Address], msg: Any) -> None:
        if self.batch is not None and type(msg) in self.batch.batchable_set:
            for d in dsts:
                self._buffer(d, msg)
            return
        self.emit(Broadcast(dsts=tuple(dsts), msg=msg))

    def set_timer(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        return self.emit(SetTimer(delay=delay, callback=fn))

    def cancel_timer(self, handle: TimerHandle) -> None:
        if handle is not None:
            handle.cancel()

    @property
    def now(self) -> float:
        return self.transport.now

    @property
    def rng(self) -> random.Random:
        return self.transport.rng

    @property
    def sim(self) -> Transport:
        """Back-compat alias: scenario scripts address the transport."""
        return self.transport

    # -- hot-path batching -------------------------------------------------
    def _buffer(self, dst: Address, msg: Any) -> None:
        buf = self._batch_buf.setdefault(dst, [])
        buf.append(msg)
        if len(buf) >= self.batch.max_batch:
            self._flush_dst(dst)
            return
        if self.batch.adaptive:
            # Debounced quiescence flush: (re-)arm a short idle timer on
            # every buffered message; cap the total wait at
            # flush_interval past the oldest buffered message.
            if self._batch_first_at is None:
                self._batch_first_at = self.now
            if self._batch_timer is not None:
                self._batch_timer.cancel()
            cap = self._batch_first_at + self.batch.flush_interval - self.now
            delay = max(0.0, min(self.batch.quiescence, cap))
            self._batch_timer = self.set_timer(delay, self._flush_all)
        elif self._batch_timer is None and self.batch.flush_interval > 0:
            self._batch_timer = self.set_timer(
                self.batch.flush_interval, self._flush_all
            )

    def _flush_dst(self, dst: Address) -> None:
        msgs = self._batch_buf.pop(dst, None)
        if not msgs:
            return
        if self.batch.sealed:
            # Sealed flushes envelope even singletons: the router's relay
            # fast path (and any FaultPlane storm aimed at it) must see
            # every coalesced client burst as a SealedBatch boundary.
            self.batches_sent += 1
            self.emit(Send(dst=dst, msg=m.SealedBatch(messages=tuple(msgs))))
        elif len(msgs) == 1:
            self.emit(Send(dst=dst, msg=msgs[0]))
        else:
            self.batches_sent += 1
            self.emit(Send(dst=dst, msg=m.Batch(messages=tuple(msgs))))

    def _flush_all(self) -> None:
        self._batch_timer = None
        self._batch_first_at = None
        for dst in list(self._batch_buf):
            self._flush_dst(dst)

    def flush_batches(self) -> None:
        """Force-flush every per-destination buffer (tests / shutdown)."""
        if self._batch_timer is not None:
            self._batch_timer.cancel()
        self._flush_all()


# ``__init_subclass__`` only fires for subclasses; seed the base table so a
# bare ProtocolNode also unwraps batch envelopes.
ProtocolNode._dispatch_names = {m.Batch: "_on_batch", m.SealedBatch: "_on_batch"}


# --------------------------------------------------------------------------
# Batching policy
# --------------------------------------------------------------------------
def _default_batchable() -> Tuple[type, ...]:
    # The command hot path: client submissions, leader->acceptor
    # proposals, acceptor->leader votes, leader->replica choices, and the
    # replicas' per-command follow-ons (client replies + replication-
    # watermark acks).  All are idempotent / monotonic, so coalescing
    # never changes semantics.  (ClientRequest only batches for clients
    # constructed WITH a batch policy — the sharded-throughput workload.)
    return (
        m.ClientRequest,
        m.Phase2A,
        m.Phase2B,
        m.Chosen,
        m.ClientReply,
        m.ReplicaAck,
    )


@dataclass
class BatchPolicy:
    """Coalesce hot-path messages per destination (paper Section 8 setup).

    ``max_batch`` messages to the same destination are wrapped in one
    ``messages.Batch`` envelope; a partial buffer is flushed after
    ``flush_interval`` seconds so latency is bounded.  Only the command
    hot path (Phase2A / Phase2B / Chosen by default) is batched —
    matchmaking, Phase 1 and reconfiguration control traffic always goes
    out immediately.
    """

    max_batch: int = 1
    flush_interval: float = 100e-6
    batchable: Tuple[type, ...] = field(default_factory=_default_batchable)
    # Adaptive flush: instead of waiting out the fixed ``flush_interval``,
    # partial buffers drain once the sender has been quiet for
    # ``quiescence`` seconds (a debounce, re-armed on every buffered
    # message), with ``flush_interval`` kept as the hard latency cap.
    # Pure flush-at-instant-end would fragment exponentially in a
    # pipelined steady state (a batch's acks arrive at slightly different
    # instants and never re-coalesce); the debounce window re-merges
    # fragments while still flushing far earlier than the fixed interval.
    adaptive: bool = False
    quiescence: float = 50e-6
    # Sealed envelopes: flush coalesced buffers as ``messages.SealedBatch``
    # (self-contained per-sub-message intern scopes) instead of ``Batch``.
    # Costs a few bytes per repeated string on the wire; buys the router's
    # zero-copy relay (forward sub-frames by slicing the received bytes).
    # Senders whose batches terminate at their destination (leaders,
    # acceptors, replicas) keep the tighter Batch encoding.
    sealed: bool = False

    def __post_init__(self) -> None:
        self.batchable_set = frozenset(self.batchable)
        if self.max_batch > 1 and self.flush_interval <= 0:
            # Without a flush timer, partial buffers below max_batch would
            # be stranded forever — a protocol stall, not a slow path.
            # (Adaptive mode also uses flush_interval, as its hard cap.)
            raise ValueError(
                "BatchPolicy with max_batch > 1 requires flush_interval > 0"
            )

    @property
    def enabled(self) -> bool:
        return self.max_batch > 1
