"""In-process asyncio transport: the same role classes over a real event loop.

``AsyncTransport`` interprets the kernel's ``Send`` / ``Broadcast`` /
``SetTimer`` / ``CancelTimer`` effects against a live ``asyncio`` loop:
message delivery is a ``call_later`` with the *identical* sender-side
network model as the simulator (``sim.plan_delivery``: base latency,
exponential jitter, seeded drop/duplicate draws, per-message egress
overhead); timers are wall-clock ``call_later`` callbacks.  Partitions
(``Simulator.partition``) are the one simulator facility with no
asyncio counterpart yet — model them with ``NetworkConfig.drop_filter``.

The point of this module is the transport boundary itself: *no role class
changes at all* between the deterministic simulator and this runtime —
``tests/core/test_runtime.py`` asserts that both transports choose
identical logs for the same client workload.  A socket-per-node TCP
transport is the same exercise with ``loop.call_later`` replaced by
``StreamWriter.write``.

Wall-clock scheduling is not deterministic, so this transport is not used
by the safety property tests; it exists to run the protocol as a real
networked service (ROADMAP north star) and to keep the kernel honest.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from .runtime import Broadcast, CancelTimer, ProtocolNode, Send, SetTimer
from .sim import Address, NetworkConfig, plan_delivery


class _AsyncTimer:
    """Timer handle over ``loop.call_later`` (or a pre-loop deferral)."""

    __slots__ = ("cancelled", "fired", "_handle")

    def __init__(self) -> None:
        self.cancelled = False
        self.fired = False
        self._handle: Optional[asyncio.TimerHandle] = None

    def cancel(self) -> None:
        self.cancelled = True
        if self._handle is not None:
            self._handle.cancel()


class AsyncTransport:
    """Runtime transport over an in-process asyncio event loop.

    Usage::

        t = AsyncTransport(seed=0)
        dep = ClusterSpec(...).instantiate(t)
        t.run(duration=2.0, until=lambda: all(c.done for c in dep.clients))

    Effects emitted before ``run()`` (e.g. by ``become_leader``) are
    queued and replayed as soon as the loop starts, so scenario scripts
    read the same as simulator scripts.
    """

    def __init__(self, seed: int = 0, net: Optional[NetworkConfig] = None):
        self.rng = random.Random(seed)
        self.net = net or NetworkConfig()
        self.nodes: Dict[Address, ProtocolNode] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._t0 = 0.0
        self._pending: List[Tuple[Address, Any, Optional[_AsyncTimer]]] = []
        self._egress_ready: Dict[Address, float] = {}
        # Paused (SIGSTOP-modelled) nodes: addr -> deferred thunks
        # (deliveries and timer fires), replayed in order on resume.
        self._paused: Dict[Address, List[Callable[[], None]]] = {}
        # Nemesis interposition point (nemesis.FaultPlane), identical to
        # Simulator.faults — this is what gives the asyncio transport
        # partitions, storms and heals with the same declarative schedules.
        self.faults: Optional[Any] = None
        # telemetry (mirrors Simulator)
        self.messages_sent = 0
        self.messages_delivered = 0
        self.messages_dropped = 0

    # -- clock -------------------------------------------------------------
    @property
    def now(self) -> float:
        if self._loop is None:
            return 0.0
        return self._loop.time() - self._t0

    # -- topology ----------------------------------------------------------
    def register(self, node: ProtocolNode) -> ProtocolNode:
        assert node.addr not in self.nodes, f"duplicate address {node.addr}"
        node.transport = self
        self.nodes[node.addr] = node
        node.on_start()
        return node

    def fail(self, addr: Address) -> None:
        self.nodes[addr].fail()

    def recover(self, addr: Address) -> None:
        self.nodes[addr].recover()

    def crash(self, addr: Address, *, clean: bool = False) -> None:
        self.nodes[addr].crash(clean=clean)

    def restart(self, addr: Address, *, wipe_volatile: bool = True) -> None:
        # A restart always yields a *running* process (matches proc:
        # respawn discards any SIGSTOP and its deferred backlog).
        self._paused.pop(addr, None)
        self.nodes[addr].restart(wipe_volatile=wipe_volatile)

    def pause(self, addr: Address) -> None:
        """SIGSTOP semantics: defer the node's deliveries and timers (in
        order) until :meth:`resume`; nothing is lost and peers keep their
        connections up."""
        self._paused.setdefault(addr, [])

    def resume(self, addr: Address) -> None:
        for thunk in self._paused.pop(addr, ()):
            thunk()

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        """Schedule a global (nemesis / scenario-script) callback at
        transport time ``when`` (mirrors Simulator.call_at)."""
        self._call_later(max(0.0, when - self.now), fn)

    # -- effect interpretation ----------------------------------------------
    def perform(self, src: Address, effect: Any) -> Optional[_AsyncTimer]:
        if isinstance(effect, Send):
            self._send(src, effect.dst, effect.msg)
        elif isinstance(effect, Broadcast):
            for d in effect.dsts:
                self._send(src, d, effect.msg)
        elif isinstance(effect, SetTimer):
            return self._set_timer(src, effect.delay, effect.callback)
        elif isinstance(effect, CancelTimer):
            if effect.handle is not None:
                effect.handle.cancel()
        else:
            raise TypeError(f"unknown effect {effect!r}")
        return None

    def _send(self, src: Address, dst: Address, msg: Any) -> None:
        self.messages_sent += 1
        src_node = self.nodes.get(src)
        if src_node is not None and src_node.failed:
            return  # a crashed node sends nothing
        extras = [0.0]
        if self.faults is not None:
            extras = self.faults.on_send(src, dst, msg, self.now, self.rng)
            if extras is None:
                self.messages_dropped += 1
                return
        delays = plan_delivery(
            self.net, self.rng, src, dst, msg, self.now, self._egress_ready
        )
        if delays is None:
            self.messages_dropped += 1
            return
        for delay in delays:
            for extra in extras:
                self._schedule_delivery(src, dst, msg, delay + extra)

    def _schedule_delivery(
        self, src: Address, dst: Address, msg: Any, delay: float
    ) -> None:
        """Hand ``msg`` to the delivery substrate after the modelled
        network delay.  The in-process transport delivers by direct call;
        ``tcp.TcpTransport`` overrides this to serialize the message onto
        a real socket instead."""
        self._call_later(delay, lambda m=msg: self._deliver(src, dst, m))

    def _deliver(self, src: Address, dst: Address, msg: Any) -> None:
        node = self.nodes.get(dst)
        if node is None or node.failed:
            self.messages_dropped += 1
            return
        if self._paused and dst in self._paused:
            self._paused[dst].append(lambda: self._deliver(src, dst, msg))
            return
        self.messages_delivered += 1
        node.on_message(src, msg)

    def _set_timer(
        self, src: Address, delay: float, fn: Callable[[], None]
    ) -> _AsyncTimer:
        if self.faults is not None:
            # Nemesis clock skew (same interposition as the simulator).
            delay = self.faults.on_timer(src, delay)
        t = _AsyncTimer()
        node_at_arm = self.nodes.get(src)
        armed_epoch = node_at_arm.life_epoch if node_at_arm is not None else 0

        def fire() -> None:
            node = self.nodes.get(src)
            if t.cancelled or (
                node is not None
                and (node.failed or node.life_epoch != armed_epoch)
            ):
                return
            if self._paused and src in self._paused:
                # A stopped process's timers fire only once it is
                # continued (re-validated then: cancel/crash still win).
                self._paused[src].append(fire)
                return
            t.fired = True
            fn()

        self._call_later(delay, fire, handle_into=t)
        return t

    def _call_later(
        self,
        delay: float,
        fn: Callable[[], None],
        handle_into: Optional[_AsyncTimer] = None,
    ) -> None:
        if self._loop is None:
            # Loop not running yet (e.g. become_leader before run()):
            # queue and replay at loop start.
            self._pending.append((delay, fn, handle_into))
            return
        handle = self._loop.call_later(delay, fn)
        if handle_into is not None:
            if handle_into.cancelled:
                handle.cancel()
            else:
                handle_into._handle = handle

    # -- driving -------------------------------------------------------------
    def run(
        self,
        duration: float,
        *,
        until: Optional[Callable[[], bool]] = None,
        poll: float = 0.002,
    ) -> float:
        """Run the event loop for up to ``duration`` wall seconds.

        Stops early once ``until()`` is true (checked every ``poll``
        seconds).  Returns the transport time consumed.
        """
        return asyncio.run(self._main(duration, until, poll))

    async def _main(
        self, duration: float, until: Optional[Callable[[], bool]], poll: float
    ) -> float:
        self._loop = asyncio.get_running_loop()
        self._t0 = self._loop.time()
        await self._on_loop_start()  # tcp: bind sockets before any send
        pending, self._pending = self._pending, []
        for delay, fn, handle_into in pending:
            self._call_later(delay, fn, handle_into=handle_into)
        start = self._loop.time()
        deadline = start + duration
        while self._loop.time() < deadline:
            if until is not None and until():
                break
            await asyncio.sleep(poll)
        elapsed = self._loop.time() - start
        await self._on_loop_stop()
        self._loop = None
        return elapsed

    async def _on_loop_start(self) -> None:  # pragma: no cover - hook
        """Subclass hook: runs once the loop exists, before pending
        effects replay (the TCP transport binds its listeners here)."""

    async def _on_loop_stop(self) -> None:  # pragma: no cover - hook
        """Subclass hook: runs after the deadline, before the loop dies."""
