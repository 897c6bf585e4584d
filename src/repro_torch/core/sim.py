"""Deterministic discrete-event network simulator.

Models the paper's asynchronous network (Section 2.1): messages may be
arbitrarily dropped, delayed, duplicated, and reordered; machines are
crash-stop (no Byzantine behaviour); there is no clock synchronization
between nodes (nodes only ever observe their own timers and inbound
messages).

Everything is driven by a single seeded RNG so that every run — including
the hypothesis property tests and the paper-figure benchmarks — is exactly
reproducible.

Hot path (the wire-plane overhaul): heap entries are closure-free
``__slots__`` event records (``_Frame`` / ``_Delivery`` / ``_TimerFire`` /
``_Call``) interpreted by a single polymorphic ``run(sim)`` — no lambda
allocation per delivery — and effect interpretation goes through a
per-class dispatch table instead of an isinstance chain.  Neither changes
event ordering: heap keys are the same ``(when, seq)`` pairs and the RNG
draw order is untouched, so legacy seeds replay byte-for-byte.

Egress frame coalescing (``NetworkConfig.egress_coalescing``) models what
a real socket transport does under backpressure: while a previous wire
frame to the same destination is still being serialized (the sender's
egress queue is busy), further messages to that destination ride the same
frame for a marginal encode cost instead of paying the full per-frame
overhead — a ``writev``/Nagle effect, and exactly how ``core/tcp.py``
behaves over real sockets.  Off by default: legacy seeds and all
``num_shards=1`` runs are byte-for-byte unchanged.
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .runtime import Broadcast, CancelTimer, ProtocolNode, Send, SetTimer

Address = str

# Protocol roles subclass the kernel's ProtocolNode; ``Node`` remains the
# historical name used throughout the role modules and tests.
Node = ProtocolNode


@dataclass
class NetworkConfig:
    """Parameters of the simulated network.

    Latency is ``base_latency + Exp(jitter)`` per message, matching the
    single-AZ EC2 deployment of the paper's Section 8 when calibrated to
    ~55us per hop.  ``extra_delay`` lets benchmarks inject message-class
    specific delays (the Section 8.2 ablation delays Phase1B and MatchB by
    250ms to simulate a WAN).

    ``per_msg_overhead`` models the sender-side serialization cost of one
    wire message (syscall + marshalling): each message departs
    ``per_msg_overhead`` after the previous one from the same sender.  A
    ``messages.Batch`` envelope counts as a single wire message — this is
    what makes hot-path batching pay, exactly as in the paper's batched
    Section 8 deployment.  Disabled (0.0) by default so legacy seeds
    reproduce byte-for-byte.

    ``egress_coalescing`` extends that model with wire-plane frame
    coalescing: messages sent to a destination whose previous frame is
    still in the sender's serialization queue join that frame, paying
    only ``coalesce_cost`` (marginal sub-message encode; defaults to an
    eighth of the per-frame overhead, the measured shape of the binary
    codec in BENCH_wire.json) instead of a full ``per_msg_overhead``.
    At most ``coalesce_max`` messages share one frame.  Messages touched
    by fault injection or drop/dup randomness always take the one-frame-
    per-message path, so every adversarial draw stays per-message.
    **Simulator-only**: the asyncio transport ignores the flag (its
    wall-clock scheduling can't model a serialization queue), and the
    TCP transport gets the same effect physically, from the kernel's
    socket buffering — do not compare sim-vs-async numbers with it set.
    """

    base_latency: float = 55e-6
    jitter: float = 8e-6
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    per_msg_overhead: float = 0.0
    # Optional hook: (src, dst, msg) -> additional seconds of delay.
    extra_delay: Optional[Callable[[Address, Address, Any], float]] = None
    # Optional hook: (src, dst, msg) -> True to force-drop.
    drop_filter: Optional[Callable[[Address, Address, Any], bool]] = None
    # Wire-plane frame coalescing (off by default: legacy byte-for-byte).
    egress_coalescing: bool = False
    coalesce_max: int = 16
    coalesce_cost: Optional[float] = None  # default: per_msg_overhead / 8


def plan_delivery(
    cfg: NetworkConfig,
    rng: random.Random,
    src: Address,
    dst: Address,
    msg: Any,
    now: float,
    egress_ready: Dict[Address, float],
) -> Optional[List[float]]:
    """The sender-side network model, shared by every transport.

    Returns the list of delivery delays (relative to ``now``, one per
    duplicate copy), or ``None`` if the message is dropped.  Mutates
    ``egress_ready`` (per-sender serialization state for
    ``per_msg_overhead``).  The RNG draw order — drop, dup, then per-copy
    jitter — is part of the determinism contract; both ``Simulator`` and
    ``net.AsyncTransport`` must route sends through here so the model
    can never drift between them.
    """
    if cfg.drop_filter is not None and cfg.drop_filter(src, dst, msg):
        return None
    if cfg.drop_prob and rng.random() < cfg.drop_prob:
        return None
    copies = 2 if cfg.dup_prob and rng.random() < cfg.dup_prob else 1
    departs = now
    if cfg.per_msg_overhead:
        # One wire message (or Batch) at a time leaves each sender,
        # per_msg_overhead apart.
        departs = max(now, egress_ready.get(src, 0.0)) + cfg.per_msg_overhead
        egress_ready[src] = departs
    delays = []
    for _ in range(copies):
        delay = cfg.base_latency
        if cfg.jitter:
            delay += rng.expovariate(1.0 / cfg.jitter)
        if cfg.extra_delay is not None:
            delay += cfg.extra_delay(src, dst, msg)
        delays.append((departs - now) + delay)
    return delays


class Timer:
    """A cancellable timer handle."""

    __slots__ = ("fired", "cancelled", "when")

    def __init__(self, when: float):
        self.when = when
        self.fired = False
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


# --------------------------------------------------------------------------
# Heap event records: closure-free, __slots__, one polymorphic run(sim).
# Heap keys stay (when, seq) so ordering is identical to the historical
# lambda-based heap — the records only replace the allocation-heavy
# closures, not the schedule.
# --------------------------------------------------------------------------
class _Delivery:
    """One message arriving at ``dst``."""

    __slots__ = ("src", "dst", "msg")

    def __init__(self, src: Address, dst: Address, msg: Any):
        self.src = src
        self.dst = dst
        self.msg = msg

    def run(self, sim: "Simulator") -> None:
        node = sim.nodes.get(self.dst)
        if node is None or node.failed:
            sim.messages_dropped += 1
            return
        if sim._paused and self.dst in sim._paused:
            sim._paused[self.dst].append(self)  # SIGSTOP: defer, don't drop
            return
        sim.messages_delivered += 1
        node.on_message(self.src, self.msg)


class _Frame:
    """A coalesced wire frame: several messages from ``src`` to ``dst``
    that shared one serialization slot, delivered back-to-back."""

    __slots__ = ("src", "dst", "depart", "msgs")

    def __init__(self, src: Address, dst: Address, depart: float, msg: Any):
        self.src = src
        self.dst = dst
        self.depart = depart  # frames accept riders until this instant
        self.msgs: List[Any] = [msg]

    def run(self, sim: "Simulator") -> None:
        node = sim.nodes.get(self.dst)
        if node is None:
            sim.messages_dropped += len(self.msgs)
            return
        if sim._paused and self.dst in sim._paused:
            sim._paused[self.dst].append(self)
            return
        src = self.src
        for msg in self.msgs:
            if node.failed:
                sim.messages_dropped += 1
            else:
                sim.messages_delivered += 1
                node.on_message(src, msg)


class _TimerFire:
    """A node-owned timer firing (suppressed on cancel/crash/past life)."""

    __slots__ = ("timer", "node", "epoch", "fn")

    def __init__(self, timer: Timer, node: Node, epoch: int, fn: Callable[[], None]):
        self.timer = timer
        self.node = node
        self.epoch = epoch
        self.fn = fn

    def run(self, sim: "Simulator") -> None:
        # Suppress cancelled timers, timers of a currently-crashed node,
        # and timers armed in a previous life (crash() bumps life_epoch,
        # so a restarted node never resurrects pre-crash timer chains
        # next to the ones on_restart re-arms).
        t = self.timer
        node = self.node
        if t.cancelled or node.failed or node.life_epoch != self.epoch:
            return
        if sim._paused and node.addr in sim._paused:
            # A SIGSTOPped process's timers don't fire; they run (and are
            # re-validated) when the process is continued.
            sim._paused[node.addr].append(self)
            return
        t.fired = True
        self.fn()


class _Call:
    """A global (oracle / scenario-script) callback."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn

    def run(self, sim: "Simulator") -> None:
        self.fn()


class Simulator:
    """Priority-queue discrete-event simulator.

    Implements the runtime ``Transport`` protocol: protocol nodes emit
    ``Send`` / ``Broadcast`` / ``SetTimer`` / ``CancelTimer`` effects and
    the simulator interprets them against its event heap through a
    per-effect-class dispatch table.
    """

    def __init__(self, seed: int = 0, net: Optional[NetworkConfig] = None):
        self.rng = random.Random(seed)
        self.net = net or NetworkConfig()
        self.now = 0.0
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = itertools.count()
        self.nodes: Dict[Address, Node] = {}
        self._partitions: List[Tuple[Set[Address], Set[Address]]] = []
        self._egress_ready: Dict[Address, float] = {}
        # Paused (SIGSTOP-modelled) nodes: addr -> deferred event records,
        # re-enqueued in order on resume.  Empty dict = fast-path falsy.
        self._paused: Dict[Address, List[Any]] = {}
        # Wire-plane frame coalescing state: the open (still-serializing)
        # frame per (src, dst) pair, joinable until its depart instant.
        self._open_frames: Dict[Tuple[Address, Address], _Frame] = {}
        self._coalesce_cost = (
            self.net.coalesce_cost
            if self.net.coalesce_cost is not None
            else self.net.per_msg_overhead / 8.0
        )
        # Optional nemesis interposition point (nemesis.FaultPlane): every
        # send is routed through it for partition / drop / dup / delay
        # faults that can be installed and healed mid-run.
        self.faults: Optional[Any] = None
        # Per-effect-class dispatch (kills the isinstance chain).
        self._perform: Dict[type, Callable[[Address, Any], Optional[Timer]]] = {
            Send: self._perform_send,
            Broadcast: self._perform_broadcast,
            SetTimer: self._perform_set_timer,
            CancelTimer: self._perform_cancel_timer,
        }
        # telemetry
        self.messages_sent = 0
        self.messages_delivered = 0
        self.messages_dropped = 0
        self.frames_coalesced = 0

    # -- topology ----------------------------------------------------------
    def register(self, node: Node) -> Node:
        assert node.addr not in self.nodes, f"duplicate address {node.addr}"
        node.transport = self
        self.nodes[node.addr] = node
        node.on_start()
        return node

    # -- effect interpretation (runtime.Transport) --------------------------
    def perform(self, src: Address, effect: Any) -> Optional[Timer]:
        try:
            handler = self._perform[type(effect)]
        except KeyError:
            raise TypeError(f"unknown effect {effect!r}") from None
        return handler(src, effect)

    def _perform_send(self, src: Address, effect: Send) -> None:
        self.send(src, effect.dst, effect.msg)

    def _perform_broadcast(self, src: Address, effect: Broadcast) -> None:
        msg = effect.msg
        for d in effect.dsts:
            self.send(src, d, msg)

    def _perform_set_timer(self, src: Address, effect: SetTimer) -> Timer:
        return self.set_timer(self.nodes[src], effect.delay, effect.callback)

    def _perform_cancel_timer(self, src: Address, effect: CancelTimer) -> None:
        if effect.handle is not None:
            effect.handle.cancel()

    def partition(self, side_a: Set[Address], side_b: Set[Address]) -> None:
        """Drop all messages between ``side_a`` and ``side_b`` until healed."""
        self._partitions.append((set(side_a), set(side_b)))

    def heal_partitions(self) -> None:
        self._partitions.clear()

    def _partitioned(self, src: Address, dst: Address) -> bool:
        for a, b in self._partitions:
            if (src in a and dst in b) or (src in b and dst in a):
                return True
        return False

    # -- event queue -------------------------------------------------------
    def _push(self, when: float, record: Any) -> None:
        heapq.heappush(self._heap, (when, next(self._seq), record))

    def set_timer(self, node: Node, delay: float, fn: Callable[[], None]) -> Timer:
        if self.faults is not None:
            # Nemesis clock skew: a node's local timers drift (scale/offset)
            # while the network clock stays truthful.
            delay = self.faults.on_timer(node.addr, delay)
        t = Timer(self.now + delay)
        self._push(self.now + delay, _TimerFire(t, node, node.life_epoch, fn))
        return t

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        """Schedule a global (oracle / scenario-script) callback."""
        self._push(when, _Call(fn))

    # -- message transport ---------------------------------------------------
    def send(self, src: Address, dst: Address, msg: Any) -> None:
        self.messages_sent += 1
        src_node = self.nodes.get(src)
        if src_node is not None and src_node.failed:
            return  # a crashed node sends nothing
        if self._partitioned(src, dst):
            self.messages_dropped += 1
            return
        disturbed = False
        extras = _NO_EXTRAS
        if self.faults is not None:
            extras = self.faults.on_send(src, dst, msg, self.now, self.rng)
            if extras is None:
                self.messages_dropped += 1
                return
            disturbed = extras != [0.0]
        cfg = self.net
        if (
            cfg.egress_coalescing
            and cfg.per_msg_overhead
            and not disturbed
            and not cfg.drop_prob
            and not cfg.dup_prob
            and cfg.drop_filter is None
        ):
            self._send_coalesced(src, dst, msg)
            return
        delays = plan_delivery(
            cfg, self.rng, src, dst, msg, self.now, self._egress_ready
        )
        if delays is None:
            self.messages_dropped += 1
            return
        now = self.now
        for delay in delays:
            for extra in extras:
                self._push(now + delay + extra, _Delivery(src, dst, msg))

    def _send_coalesced(self, src: Address, dst: Address, msg: Any) -> None:
        """Wire-plane egress: join the open frame to ``dst`` if the sender
        is still serializing it (backpressure), else start a new frame.
        The join costs only the marginal sub-message encode time — the
        same ``writev`` effect the TCP transport gets from the kernel."""
        cfg = self.net
        key = (src, dst)
        fr = self._open_frames.get(key)
        if fr is not None and fr.depart > self.now and len(fr.msgs) < cfg.coalesce_max:
            fr.msgs.append(msg)
            self.frames_coalesced += 1
            # Marginal serialization time still occupies the egress queue.
            self._egress_ready[src] = (
                self._egress_ready.get(src, 0.0) + self._coalesce_cost
            )
            return
        departs = (
            max(self.now, self._egress_ready.get(src, 0.0)) + cfg.per_msg_overhead
        )
        self._egress_ready[src] = departs
        delay = cfg.base_latency
        if cfg.jitter:
            delay += self.rng.expovariate(1.0 / cfg.jitter)
        if cfg.extra_delay is not None:
            delay += cfg.extra_delay(src, dst, msg)
        fr = _Frame(src, dst, departs, msg)
        self._open_frames[key] = fr
        self._push(departs + delay, fr)

    def _deliver(self, src: Address, dst: Address, msg: Any) -> None:
        node = self.nodes.get(dst)
        if node is None or node.failed:
            self.messages_dropped += 1
            return
        self.messages_delivered += 1
        node.on_message(src, msg)

    # -- control -------------------------------------------------------------
    def fail(self, addr: Address) -> None:
        self.nodes[addr].fail()

    def recover(self, addr: Address) -> None:
        self.nodes[addr].recover()

    def crash(self, addr: Address, *, clean: bool = False) -> None:
        """Crash a node (clean=SIGTERM flushes batches, else kill -9)."""
        self.nodes[addr].crash(clean=clean)

    def restart(self, addr: Address, *, wipe_volatile: bool = True) -> None:
        # A restart always yields a *running* process: any SIGSTOP (and
        # its deferred backlog) died with the old incarnation — matching
        # the proc plane, where a respawned process is never stopped.
        self._paused.pop(addr, None)
        self.nodes[addr].restart(wipe_volatile=wipe_volatile)

    def pause(self, addr: Address) -> None:
        """SIGSTOP semantics: the node stops executing (no deliveries, no
        timers) but loses nothing; peers still see it as connected."""
        self._paused.setdefault(addr, [])

    def resume(self, addr: Address) -> None:
        """SIGCONT: replay the deferred backlog in its original order."""
        for record in self._paused.pop(addr, ()):
            self._push(self.now, record)

    def step(self) -> bool:
        if not self._heap:
            return False
        when, _, record = heapq.heappop(self._heap)
        assert when >= self.now - 1e-12, "time went backwards"
        if when > self.now:
            self.now = when
        record.run(self)
        return True

    def run_until(self, t: float, max_events: int = 50_000_000) -> None:
        heap = self._heap
        events = 0
        while heap and heap[0][0] <= t:
            self.step()
            events += 1
            if events > max_events:
                raise RuntimeError("event budget exhausted — livelock?")
        self.now = max(self.now, t)

    def run_for(self, dt: float, **kw) -> None:
        self.run_until(self.now + dt, **kw)

    def run_to_quiescence(self, max_events: int = 5_000_000) -> None:
        events = 0
        while self._heap:
            self.step()
            events += 1
            if events > max_events:
                raise RuntimeError("event budget exhausted — livelock?")

    # -- model-checking hooks (the verification plane, core/mc.py) ---------
    # The explorer never calls step(): it picks pending events by their
    # stable insertion seq and runs them out of heap order, which is what
    # lets it enumerate every delivery/timer interleaving the asynchronous
    # network model allows.  Seq ids come from the same deterministic
    # counter as normal runs, so a (family build, choice prefix) pair
    # always rebuilds the identical state — the fork-by-replay the
    # explorer's backtracking is built on.
    def pending_events(self) -> List[Tuple[int, Any]]:
        """The enabled-event frontier: every live heap record as
        ``(seq, record)`` in stable insertion order.  Stale timer records
        — cancelled, or armed in a previous life of a since-crashed node
        — are excluded (running them is a no-op by construction)."""
        out = []
        for _, seq, record in self._heap:
            if type(record) is _TimerFire and (
                record.timer.cancelled or record.node.life_epoch != record.epoch
            ):
                continue
            out.append((seq, record))
        out.sort()
        return out

    def run_event(self, seq: int) -> None:
        """Run one specific pending event, out of heap order.  The clock
        only ever moves forward (``max(now, when)``); relative event order
        is entirely the caller's choice."""
        when, record = self._take_event(seq)
        if when > self.now:
            self.now = when
        record.run(self)

    def discard_event(self, seq: int) -> None:
        """Remove a pending delivery: the network lost this message."""
        self._take_event(seq)
        self.messages_dropped += 1

    def duplicate_event(self, seq: int) -> int:
        """Enqueue a copy of a pending delivery (the network duplicated
        it); returns the copy's seq.  The copy draws the next seq from the
        deterministic counter, so replays allocate identically."""
        for when, s, record in self._heap:
            if s == seq:
                assert type(record) is _Delivery, "only deliveries duplicate"
                new_seq = next(self._seq)
                heapq.heappush(
                    self._heap,
                    (when, new_seq, _Delivery(record.src, record.dst, record.msg)),
                )
                return new_seq
        raise KeyError(f"no pending event #{seq}")

    def _take_event(self, seq: int) -> Tuple[float, Any]:
        for i, (when, s, record) in enumerate(self._heap):
            if s == seq:
                last = self._heap.pop()
                if i < len(self._heap):
                    self._heap[i] = last
                    heapq.heapify(self._heap)
                return when, record
        raise KeyError(f"no pending event #{seq}")


def event_kind(record: Any) -> str:
    """Classify a heap record: deliver | frame | timer | call."""
    t = type(record)
    if t is _Delivery:
        return "deliver"
    if t is _Frame:
        return "frame"
    if t is _TimerFire:
        return "timer"
    return "call"


def event_target(record: Any) -> Optional[Address]:
    """The node a heap record touches when run (None = global callback)."""
    t = type(record)
    if t is _Delivery or t is _Frame:
        return record.dst
    if t is _TimerFire:
        return record.node.addr
    return None


# FaultPlane.on_send returns a fresh [0.0] for undisturbed sends; this
# module-level constant is only the no-faults default in Simulator.send.
_NO_EXTRAS = [0.0]
