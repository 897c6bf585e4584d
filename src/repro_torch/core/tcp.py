"""Layer 0 — a real TCP transport: socket per node, binary frames.

The long-standing ROADMAP transport follow-on: the *same unmodified* role
classes run over real kernel sockets.  Every node registered on a
:class:`TcpTransport` gets its own listening socket on loopback; a send
is (1) routed through the identical sender-side network model as the
simulator (``sim.plan_delivery``: seeded drop/dup/jitter draws and the
``FaultPlane`` nemesis interposition — partitions, storms, clock skew all
work unchanged), then (2) serialized with the wire-plane binary codec
(``core/wire.py``) and written to the destination's socket as a
length-prefixed frame.  The receiving node's reader task decodes frames
and dispatches them through the normal kernel path.

Connections are opened lazily, one per ordered ``(src, dst)`` pair, and
announce the sender with a hello frame (the src address) so the receiver
can attribute messages.  Frames queued while a connection is still being
established are flushed in order once it is up — per-pair FIFO, exactly
the guarantee TCP itself gives.  Reordering across pairs (and across
messages of one pair, via the modelled jitter applied *before* the
write) is therefore as adversarial as the asyncio transport.

Multi-process readiness (the proc plane builds on this file): listeners
bind ephemeral port 0 with ``SO_REUSEADDR`` and the address->port map is
resolved through the overridable ``_resolve_port`` hook, so subclasses
can rendezvous ports across OS processes; a peer that goes away (its
connection EOFs or a connect fails) has its cached port and writer
invalidated so the next send re-resolves — which is what lets a restarted
process come back on a fresh port.  Shutdown is graceful: per-(src,dst)
writers are drained before closing, so in-flight frames are delivered
rather than reset.

Crash-stop faults keep their transport-level meaning: a crashed node's
frames are suppressed at the sender and dropped at the receiver; the
sockets stay up, exactly like a wedged-but-connected process.

This transport inherits the asyncio runtime machinery of
``net.AsyncTransport`` (timers, pending-effect replay, ``call_at``,
``run``) and overrides only the delivery substrate — the point of the
transport boundary is that this file is *all* it takes to move from an
in-process event loop to real sockets.
"""

from __future__ import annotations

import asyncio
import struct
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import wire
from .net import AsyncTransport
from .runtime import ProtocolNode
from .sim import Address, NetworkConfig

_U32 = struct.Struct("<I")
_MAX_FRAME = 64 * 1024 * 1024  # sanity bound; a frame this big is a bug
_MAX_OUTBOX = 1024  # per-(src,dst) queued-frame cap while a peer is down
_RETRY_MIN, _RETRY_MAX = 0.01, 0.5  # reconnect backoff bounds


class TcpTransport(AsyncTransport):
    """Runtime transport over per-node TCP sockets (loopback).

    Usage mirrors ``AsyncTransport``::

        t = TcpTransport(seed=0)
        dep = ClusterSpec(...).instantiate(t)
        t.run(duration=2.0, until=lambda: all(c.done for c in dep.clients))

    Nodes registered after ``run()`` has started get their listener bound
    on the fly; frames addressed to a node whose listener is not up yet
    queue and flush in order.
    """

    def __init__(
        self,
        seed: int = 0,
        net: Optional[NetworkConfig] = None,
        *,
        host: str = "127.0.0.1",
    ):
        super().__init__(seed=seed, net=net)
        self.host = host
        self._servers: Dict[Address, asyncio.AbstractServer] = {}
        self._ports: Dict[Address, int] = {}
        # One outgoing connection per ordered (src, dst) pair; frames
        # buffered per pair until the connection (and dst listener) is up.
        self._writers: Dict[Tuple[Address, Address], asyncio.StreamWriter] = {}
        self._outbox: Dict[Tuple[Address, Address], Deque[bytes]] = {}
        self._connecting: Dict[Tuple[Address, Address], bool] = {}
        self._retry_pending: set = set()
        self._retry_delay: Dict[Tuple[Address, Address], float] = {}
        self._reader_tasks: List[asyncio.Task] = []
        # telemetry
        self.bytes_sent = 0
        self.bytes_received = 0
        self.frames_sent = 0
        self.frames_received = 0
        self.frames_dropped_backpressure = 0

    # -- topology ----------------------------------------------------------
    def register(self, node: ProtocolNode) -> ProtocolNode:
        node = super().register(node)
        if self._loop is not None:  # late registration while running
            self._loop.create_task(self._bind(node.addr))
        return node

    # -- lifecycle ---------------------------------------------------------
    async def _on_loop_start(self) -> None:
        for addr in list(self.nodes):
            await self._bind(addr)

    async def _on_loop_stop(self) -> None:
        # Graceful shutdown: drain every per-(src,dst) connection before
        # closing it, so frames already handed to the kernel (or still in
        # the stream writer's buffer) are delivered instead of reset.
        # (Snapshot the dicts: peer-watch tasks prune entries concurrently.)
        for writer in list(self._writers.values()):
            try:
                await asyncio.wait_for(writer.drain(), timeout=0.5)
            except Exception:
                pass
        for task in list(self._reader_tasks):
            task.cancel()
        for writer in list(self._writers.values()):
            try:
                writer.close()
            except Exception:
                pass
        for server in self._servers.values():
            server.close()
        self._writers.clear()
        self._connecting.clear()
        self._servers.clear()
        self._ports.clear()

    async def _bind(self, addr: Address) -> None:
        if addr in self._servers:
            return

        async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
            task = asyncio.current_task()
            if task is not None:
                self._reader_tasks.append(task)
            try:
                src = await self._read_hello(reader)
                # The hello names the address the dialer *meant* to
                # reach.  If the OS recycled a dead peer's ephemeral
                # port for this listener, that is not us: hang up, so
                # the dialer invalidates its stale port and re-resolves
                # — never misattribute frames to the wrong node.
                src, _, intended = src.partition("\x00")
                if intended and intended != addr:
                    return
                while True:
                    payload = await self._read_frame(reader)
                    if payload is None:
                        return
                    self.frames_received += 1
                    self.bytes_received += 4 + len(payload)
                    self._deliver(src, addr, wire.decode_frame(payload))
            except (
                asyncio.CancelledError,
                asyncio.IncompleteReadError,
                ConnectionError,
            ):
                return
            finally:
                if task is not None and task in self._reader_tasks:
                    self._reader_tasks.remove(task)
                try:
                    writer.close()
                except Exception:
                    pass

        # SO_REUSEADDR so a respawned process can rebind promptly even if
        # its predecessor's socket lingers in TIME_WAIT.
        server = await asyncio.start_server(
            handle, host=self.host, port=0, reuse_address=True
        )
        self._servers[addr] = server
        self._ports[addr] = server.sockets[0].getsockname()[1]
        # A listener coming up may unblock queued frames to this addr.
        for (src, dst) in list(self._outbox):
            if dst == addr:
                self._pump(src, dst)

    @staticmethod
    async def _read_hello(reader: asyncio.StreamReader) -> Address:
        (n,) = _U32.unpack(await reader.readexactly(4))
        return (await reader.readexactly(n)).decode("utf-8")

    @staticmethod
    async def _read_frame(reader: asyncio.StreamReader) -> Optional[bytes]:
        try:
            (n,) = _U32.unpack(await reader.readexactly(4))
        except asyncio.IncompleteReadError:
            return None  # clean EOF between frames
        if n > _MAX_FRAME:
            raise ValueError(f"oversized frame ({n} bytes)")
        return await reader.readexactly(n)

    # -- the delivery substrate (overrides net.AsyncTransport) -------------
    def _schedule_delivery(
        self, src: Address, dst: Address, msg: Any, delay: float
    ) -> None:
        # The network model (drops, dup, jitter, faults) already ran in
        # _send; after the modelled delay the frame goes onto the socket.
        self._call_later(delay, lambda m=msg: self._transmit(src, dst, m))

    def _transmit(self, src: Address, dst: Address, msg: Any) -> None:
        key = (src, dst)
        # wire.frame owns the frame format (length prefix included);
        # _read_frame is its read-side mirror.
        box = self._outbox.setdefault(key, deque())
        box.append(wire.frame(msg))
        # Bound the per-pair backlog: a peer that stays unreachable (a
        # SIGKILLed, never-restarted process) must not grow memory with
        # the send rate.  Dropping the oldest frames is legal — the
        # modelled network is lossy and every protocol path retries.
        while len(box) > _MAX_OUTBOX:
            box.popleft()
            self.frames_dropped_backpressure += 1
        self._pump(src, dst)

    def _resolve_port(self, dst: Address) -> Optional[int]:
        """Map an address to its listening port.  The in-process transport
        knows every port from its own ``_bind``; the proc plane overrides
        this to consult the cross-process rendezvous directory."""
        return self._ports.get(dst)

    def _invalidate_peer(self, dst: Address) -> None:
        """Forget a peer's cached port unless we host its listener
        ourselves — a remote process that died (or restarted onto a fresh
        ephemeral port) must be re-resolved, not re-dialed."""
        if dst not in self._servers:
            self._ports.pop(dst, None)

    def _drop_writer(self, key: Tuple[Address, Address]) -> None:
        writer = self._writers.pop(key, None)
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass
        self._invalidate_peer(key[1])

    def _schedule_retry(self, key: Tuple[Address, Address]) -> None:
        """Re-pump a pair later (unresolved peer / failed connect); at
        most one pending retry per pair, with exponential backoff toward
        ``_RETRY_MAX`` so a permanently-dead peer costs one dial every
        half second, not a hundred per second."""
        if not self._outbox.get(key) or key in self._retry_pending:
            return
        self._retry_pending.add(key)
        delay = self._retry_delay.get(key, _RETRY_MIN)
        self._retry_delay[key] = min(delay * 2, _RETRY_MAX)

        def retry() -> None:
            self._retry_pending.discard(key)
            self._pump(*key)

        self._call_later(delay, retry)

    def _pump(self, src: Address, dst: Address) -> None:
        key = (src, dst)
        writer = self._writers.get(key)
        if writer is not None and writer.is_closing():
            self._drop_writer(key)
            writer = None
        if writer is not None:
            box = self._outbox.get(key)
            while box:
                data = box.popleft()
                self.frames_sent += 1
                self.bytes_sent += len(data)
                writer.write(data)
            return
        if self._connecting.get(key) or self._loop is None:
            return
        port = self._resolve_port(dst)
        if port is None:
            # Listener not up yet: _bind() re-pumps for local peers; for
            # remote (rendezvous) peers, retry shortly — the frames stay
            # queued per-pair in order.
            if dst not in self._servers:
                self._schedule_retry(key)
            return
        self._ports.setdefault(dst, port)
        self._connecting[key] = True
        self._loop.create_task(self._connect(key, port))

    async def _connect(self, key: Tuple[Address, Address], port: int) -> None:
        src, dst = key
        try:
            reader, writer = await asyncio.open_connection(self.host, port)
        except OSError:
            self._connecting[key] = False
            # A dead port (process gone / restarted elsewhere): re-resolve
            # on the retry instead of re-dialing the corpse.
            self._invalidate_peer(dst)
            self._schedule_retry(key)
            return
        # Announce who we are AND who we meant to dial: a recycled
        # ephemeral port belonging to some other node hangs up on the
        # mismatch instead of consuming our frames.
        hello = f"{src}\x00{dst}".encode("utf-8")
        writer.write(_U32.pack(len(hello)) + hello)
        self._writers[key] = writer
        self._connecting[key] = False
        self._retry_delay.pop(key, None)  # reachable again: reset backoff
        self._loop.create_task(self._watch_peer(key, reader, writer))
        self._pump(src, dst)

    async def _watch_peer(
        self,
        key: Tuple[Address, Address],
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        """Outgoing connections are write-only; the only thing the peer
        ever sends back is EOF/reset when it goes away.  Await it so a
        dead connection is torn down eagerly and the next send
        re-resolves the peer's port (it may have restarted)."""
        task = asyncio.current_task()
        if task is not None:
            self._reader_tasks.append(task)
        try:
            await reader.read()
        except (asyncio.CancelledError, ConnectionError, OSError):
            return
        finally:
            if task is not None and task in self._reader_tasks:
                self._reader_tasks.remove(task)
            if self._writers.get(key) is writer:
                self._drop_writer(key)
