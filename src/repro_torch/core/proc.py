"""Layer −1 — the process plane: one OS process per node.

Everything below this layer has run the protocol inside a single Python
interpreter — even the TCP transport kept every role in one process and
merely moved its frames through the kernel.  This module is the missing
deployment shape the reconfiguration literature insists on testing
(Bortnikov et al.; Schultz et al.): each node (proposers, acceptors,
matchmakers, replicas, the router) is its **own OS process** hosting an
*unmodified* role class on a single-node :class:`WorkerRuntime` (a
``tcp.TcpTransport`` that binds exactly one listener), while a
:class:`Supervisor` in the parent spawns/joins the workers, rendezvouses
their ephemeral ports through per-address files, streams per-node logs,
and maps nemesis faults onto real POSIX semantics:

  ===============================  =====================================
  fault                            process semantics
  ===============================  =====================================
  ``Crash(clean=False)``           ``SIGKILL`` — volatile state is gone
  ``Crash(clean=True)``            ``SIGTERM`` — flush batches, persist,
                                   exit 0
  ``Restart``                      re-spawn; recover from the state file
  ``Pause`` / ``Resume``           ``SIGSTOP`` / ``SIGCONT`` — wedged but
                                   connected (gray failure)
  ``DiskLoss``                     delete the state file (dead victim) or
                                   a ``CtlWipeDisk`` control frame (live)
  ``Partition``/``Storm``/``Heal`` fanned out to every worker's local
  /``ClockSkew``                   ``FaultPlane`` via control frames
  ===============================  =====================================

**Durability.**  Acceptors, matchmakers and replicas carry real
persistent state across process boundaries: their
``persistent_state()`` dict is serialized through the wire codec
(``wire.encode_state``, versioned like every frame) to
``<workdir>/state/<addr>.state``.  The worker host enforces the paper's
crash-recovery contract — state is written *before* any response frame
leaves the process (write-ahead of the send), plus periodic checkpoints
and a final write on clean shutdown — so a ``SIGKILL``-ed acceptor
re-spawned from its file answers exactly as if it had only been slow.
This is what finally makes ``reset_volatile`` real: a restarted process
*is* a fresh interpreter; whatever was not persisted is simply gone.

**Checking.**  The invariant checker cannot peek across process
boundaries mid-run, so the proc plane checks at teardown: every worker
persists a final snapshot (state + a report of its learned chosen log
and oracle observations) on SIGTERM; the parent merges the per-proposer
oracles and every replica's persisted log into one global oracle and
runs the full ``nemesis.check_invariants`` suite over shadow objects.
Because replicas persist before replying, any client-observed result is
backed by a persisted log prefix — the linearizability check is sound
even against a SIGKILL-ed worker's last checkpoint.

Deploy surface parity: ``ClusterSpec.deploy(backend="proc")``,
``make_transport("proc")`` and ``run_scenario(transport="proc")`` all
work; clients (the measurement harness) live in the parent on
:class:`ProcTransport`, the parent's own TcpTransport whose missing
peers resolve through the rendezvous directory.
"""

from __future__ import annotations

import argparse
import os
import pickle
import signal
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import messages as m
from . import wire
from .acceptor import Acceptor
from .client import Client, ShardRouter, shard_of_command
from .matchmaker import Matchmaker
from .mm_reconfig import MMReconfigCoordinator
from .nemesis import FaultPlane, Nemesis, Storm, check_invariants
from .oracle import Oracle, SafetyViolation
from .proposer import Options, Proposer
from .quorums import Configuration
from .replica import Replica
from .runtime import Broadcast, ProtocolNode, Send
from .sim import Address, NetworkConfig
from .tcp import TcpTransport

SUPERVISOR_ADDR = "__sup__"

# Proc scenarios run the same declarative schedules as every other
# backend, stretched by this factor: process spawn/respawn costs real
# wall time (a fresh interpreter imports the package), which the
# sim-calibrated event times don't budget for.
PROC_TIME_SCALE = 8.0

# Scenario names that run on the proc backend (fast_paxos_recovery wires
# a bespoke in-process topology and is excluded).
def proc_scenario_names() -> Tuple[str, ...]:
    from .scenarios import SCENARIO_NAMES

    return tuple(n for n in SCENARIO_NAMES if n != "fast_paxos_recovery")


# --------------------------------------------------------------------------
# Control frames (supervisor -> worker).  Plain dataclasses: the wire
# codec's pickle fallback carries them, and both endpoints are always the
# same build (the parent spawned the worker).
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CtlBecomeLeader:
    config: Configuration


@dataclass(frozen=True)
class CtlReconfigure:
    config: Configuration


@dataclass(frozen=True)
class CtlMMReconfigure:
    old: Tuple[Address, ...]
    new: Tuple[Address, ...]


@dataclass(frozen=True)
class CtlWipeDisk:
    pass


@dataclass(frozen=True)
class CtlFault:
    """Install a fault on the worker's local FaultPlane.  ``op`` is one of
    ``partition`` / ``storm`` / ``skew`` / ``heal``; ``payload`` carries
    the fault parameters."""

    op: str
    payload: Tuple[Any, ...] = ()


# --------------------------------------------------------------------------
# Rendezvous: address -> ephemeral port, via per-address files
# --------------------------------------------------------------------------
class Rendezvous:
    """Port rendezvous through a shared directory.

    Every process (workers and the parent) binds port 0 and publishes
    ``<root>/ports/<addr>`` atomically; senders resolve lazily and
    re-resolve whenever a connection dies, so a respawned process on a
    fresh port is found without coordination."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.ports_dir = self.root / "ports"
        self.ports_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, addr: Address) -> Path:
        assert "/" not in addr and addr not in (".", ".."), addr
        return self.ports_dir / addr

    def publish(self, addr: Address, port: int) -> None:
        tmp = self._path(addr).with_suffix(".tmp")
        tmp.write_text(str(port))
        tmp.replace(self._path(addr))

    def clear(self, addr: Address) -> None:
        try:
            self._path(addr).unlink()
        except FileNotFoundError:
            pass

    def lookup(self, addr: Address) -> Optional[int]:
        try:
            return int(self._path(addr).read_text())
        except (FileNotFoundError, ValueError):
            return None

    def wait_all(self, addrs: Sequence[Address], timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        missing = list(addrs)
        while missing:
            missing = [a for a in missing if self.lookup(a) is None]
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers never published ports: {missing}")
            time.sleep(0.02)


class FileLeaderProvider:
    """A picklable leader provider for worker-hosted routers: reads the
    supervisor-maintained leaders file (mtime-cached) and returns the
    current leader address of its shard."""

    def __init__(self, path: str, shard: int):
        self.path = str(path)
        self.shard = shard
        self._mtime = -1.0
        self._leaders: Dict[int, str] = {}

    def __call__(self) -> Optional[Address]:
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            return None
        if mtime != self._mtime:
            self._mtime = mtime
            leaders: Dict[int, str] = {}
            try:
                for line in Path(self.path).read_text().splitlines():
                    shard_str, _, addr = line.partition(" ")
                    if addr:
                        leaders[int(shard_str)] = addr
            except OSError:
                return self._leaders.get(self.shard)
            self._leaders = leaders
        return self._leaders.get(self.shard)

    def __getstate__(self):  # the cache never travels
        return {"path": self.path, "shard": self.shard}

    def __setstate__(self, state):
        self.__init__(state["path"], state["shard"])


# --------------------------------------------------------------------------
# Node construction: ClusterSpec address -> role object (the worker-side
# mirror of ClusterSpec.instantiate, minus the in-process closures)
# --------------------------------------------------------------------------
def leaders_path(workdir: Path) -> Path:
    return Path(workdir) / "leaders"


def worker_addrs(spec: Any) -> Tuple[Address, ...]:
    """Every address the proc plane runs as its own OS process (clients
    stay in the parent: they are the measurement harness)."""
    S = max(1, spec.num_shards)
    addrs = (
        spec.all_proposer_addrs()
        + spec.all_acceptor_addrs()
        + spec.matchmaker_addrs()
        + spec.standby_matchmaker_addrs()
        + spec.replica_addrs()
        + ("mmcoord",)
    )
    if S > 1 or spec.route_via_router:
        addrs += (spec.router_addr(),)
    return addrs


def build_worker_node(spec: Any, addr: Address, workdir: Path) -> ProtocolNode:
    """Construct the role node for ``addr`` exactly as
    ``ClusterSpec.instantiate`` would, with the in-process closures
    replaced by their cross-process equivalents (file-based leader
    providers; SetMatchmakers fan-out messages)."""
    f = spec.f
    S = max(1, spec.num_shards)
    opts = spec.options or Options()
    batch = opts.batch_policy()
    mm_addrs = spec.matchmaker_addrs()
    rep_addrs = spec.replica_addrs()
    all_prop_addrs = spec.all_proposer_addrs()

    if addr in mm_addrs:
        return Matchmaker(addr)
    if addr in spec.standby_matchmaker_addrs():
        return Matchmaker(addr, enabled=False)
    if addr in rep_addrs:
        return Replica(
            addr,
            spec.sm_factory,
            leader_addrs=all_prop_addrs,
            peers=rep_addrs,
            batch=batch,
            num_shards=S,
            ack_stride=spec.replica_ack_stride(),
            leader_groups=tuple(
                spec.shard_proposer_addrs(s) for s in range(S)
            ),
        )
    for s in range(S):
        props = spec.shard_proposer_addrs(s)
        if addr in props:
            return Proposer(
                addr,
                props.index(addr),
                matchmakers=mm_addrs,
                replicas=rep_addrs,
                proposers=props,
                oracle=Oracle(),
                options=opts,
                f=f,
                shard=s,
                num_shards=S,
            )
        if addr in spec.shard_acceptor_addrs(s):
            return Acceptor(addr, batch=batch)
    if addr == "mmcoord":
        return MMReconfigCoordinator(
            "mmcoord", 99, f=f, notify_proposers=all_prop_addrs
        )
    if addr == spec.router_addr():
        return ShardRouter(
            addr,
            [FileLeaderProvider(str(leaders_path(workdir)), s) for s in range(S)],
            batch=batch if spec.router_coalesce else None,
            affinity_run=getattr(spec, "shard_affinity_run", 1),
        )
    raise ValueError(f"no role for address {addr!r} in this spec")


# --------------------------------------------------------------------------
# Write-ahead log: the durable roles' per-message journal
# --------------------------------------------------------------------------
# A full-state snapshot per reply would be O(log) bytes per message —
# O(n^2) over a run.  Instead the worker journals each *inbound message*
# (already wire-encodable) to ``state/<addr>.wal`` ahead of any send it
# causes, and the periodic checkpoint writes the O(n) snapshot and
# truncates the journal.  Recovery = load snapshot + replay the journal
# through the node's own handlers with outbound I/O suppressed — sound
# because the durable roles (acceptor, matchmaker, replica) are
# deterministic functions of their inbound message sequence, and safe
# under the crash-between-snapshot-and-truncate race because their
# handlers are idempotent (re-promising a promised round, re-inserting a
# chosen value, re-raising a watermark are all no-ops).
#
# Record format: [u8 src length][src utf8][wire frame of the message].
def _wal_record(src: Address, msg: Any) -> bytes:
    raw = src.encode("utf-8")
    return bytes((len(raw),)) + raw + wire.frame(msg)


def iter_wal(path: Path):
    """Yield (src, msg) records; stops cleanly at a torn final record
    (a crash mid-append truncates, it must never corrupt recovery)."""
    try:
        data = path.read_bytes()
    except OSError:
        return
    pos, n = 0, len(data)
    while pos < n:
        srclen = data[pos]
        head = pos + 1 + srclen
        if head + 4 > n:
            return  # torn record
        src = data[pos + 1 : head].decode("utf-8")
        (framelen,) = struct.unpack_from("<I", data, head)
        end = head + 4 + framelen
        if end > n:
            return  # torn record
        yield src, wire.decode_frame(data[head + 4 : end])
        pos = end


def _replay_into(node: ProtocolNode, wal_path: Path) -> None:
    """Apply a journal to a freshly-loaded node (outbound I/O must already
    be suppressed by the caller's transport)."""
    for src, msg in iter_wal(wal_path):
        if isinstance(msg, CtlWipeDisk):
            if isinstance(node, Replica):
                node.lose_disk()
        elif isinstance(
            msg, (CtlBecomeLeader, CtlReconfigure, CtlMMReconfigure, CtlFault)
        ):
            continue  # volatile-role / transient-network controls
        else:
            node.on_message(src, msg)


class _NullTransport:
    """Absorbs every effect: lets the parent (or a recovery pass) run a
    role's handlers purely for their state transitions."""

    def __init__(self) -> None:
        import random

        self.rng = random.Random(0)

    @property
    def now(self) -> float:
        return 0.0

    def register(self, node: ProtocolNode) -> ProtocolNode:
        node.transport = self
        return node

    def perform(self, src: Address, effect: Any):
        return None


def recover_node(spec: Any, addr: Address, workdir: Path) -> ProtocolNode:
    """Reconstruct a durable role's state exactly as a respawned worker
    would: snapshot + journal replay.  Used by the worker on restart and
    by the parent's teardown-time invariant gather."""
    node = build_worker_node(spec, addr, Path(workdir))
    _NullTransport().register(node)
    state_dir = Path(workdir) / "state"
    snap_path = state_dir / f"{addr}.state"
    if snap_path.exists():
        snapshot = wire.decode_state(snap_path.read_bytes())
        if snapshot.get("persistent") is not None and hasattr(
            node, "load_persistent_state"
        ):
            node.load_persistent_state(snapshot["persistent"])
    _replay_into(node, state_dir / f"{addr}.wal")
    return node


class _RendezvousTransport(TcpTransport):
    """TcpTransport whose peers rendezvous through the shared port
    directory: own listeners are published on bind, unknown destinations
    resolve from the directory (and re-resolve after connection death,
    via the base class's invalidation).  Both sides of the process
    boundary — worker and parent — share this behaviour."""

    rendezvous: Rendezvous  # set by subclass __init__

    async def _bind(self, addr: Address) -> None:
        await super()._bind(addr)
        self.rendezvous.publish(addr, self._ports[addr])

    def _resolve_port(self, dst: Address) -> Optional[int]:
        port = self._ports.get(dst)
        if port is None:
            port = self.rendezvous.lookup(dst)
        return port


# --------------------------------------------------------------------------
# Worker side: a TcpTransport hosting exactly one node
# --------------------------------------------------------------------------
class WorkerRuntime(_RendezvousTransport):
    """The one-node transport a worker process runs.

    Identical to ``TcpTransport`` except that (1) the hosted node's
    listener port is published to the rendezvous directory, (2) peers'
    ports resolve *from* that directory (re-resolved on connection
    death, so respawned peers are found on their fresh ports), and
    (3) the :class:`NodeHost` interposes on delivery/timers/sends to
    enforce persist-before-send durability and to intercept the
    supervisor's control frames."""

    def __init__(self, rendezvous: Rendezvous, seed: int = 0, net=None):
        super().__init__(seed=seed, net=net)
        self.rendezvous = rendezvous
        self.node_host: Optional["NodeHost"] = None
        self.faults = FaultPlane()  # CtlFault installs into this

    # -- host interposition -------------------------------------------------
    def perform(self, src: Address, effect: Any):
        host = self.node_host
        if host is not None:
            if host.replaying:
                return None  # recovery replay: state transitions only
            if type(effect) in (Send, Broadcast):
                host.flush_wal()  # journal write-ahead of the send
        return super().perform(src, effect)

    def _deliver(self, src: Address, dst: Address, msg: Any) -> None:
        host = self.node_host
        if host is not None:
            host.on_inbound(src, msg)  # journal + dirty (CtlWipeDisk mutates too)
            if host.maybe_handle_control(src, msg):
                return
        super()._deliver(src, dst, msg)

    def _set_timer(self, src: Address, delay: float, fn: Callable[[], None]):
        host = self.node_host
        if host is not None:
            if host.replaying:
                return None  # timers are re-armed after recovery
            inner = fn

            def fired() -> None:
                host.mark_dirty()
                inner()

            fn = fired
        return super()._set_timer(src, delay, fn)

    async def _on_loop_start(self) -> None:
        await super()._on_loop_start()
        if self.node_host is not None:
            self.node_host.on_loop_start(self._loop)

    async def _on_loop_stop(self) -> None:
        # Flush the node's buffered batches onto live connections and
        # persist a final snapshot while the loop still exists; the
        # superclass then drains every writer so the flushed frames are
        # delivered, not reset.  Covers both the SIGTERM and the
        # duration-expired paths.
        if self.node_host is not None:
            self.node_host.on_loop_stopping()
        await super()._on_loop_stop()


class NodeHost:
    """Hosts one role node inside a worker process: state files,
    write-ahead persistence, checkpoints, signal handling, control
    frames."""

    def __init__(
        self,
        spec: Any,
        addr: Address,
        workdir: Path,
        *,
        seed: int = 0,
        recover: bool = False,
        net: Optional[NetworkConfig] = None,
        checkpoint_interval: float = 0.05,
        persist_interval: float = 0.25,
        wal_max_bytes: int = 256 << 10,
    ):
        self.addr = addr
        self.workdir = Path(workdir)
        self.recover = recover
        self.checkpoint_interval = checkpoint_interval
        self.state_dir = self.workdir / "state"
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.state_path = self.state_dir / f"{addr}.state"
        self.wal_path = self.state_dir / f"{addr}.wal"
        self.rendezvous = Rendezvous(self.workdir)
        self.transport = WorkerRuntime(
            self.rendezvous, seed=seed, net=net or NetworkConfig()
        )
        self.transport.node_host = self
        self.node = build_worker_node(spec, addr, self.workdir)
        self._dirty = False
        self._shutdown = False
        self.replaying = False
        self.persists = hasattr(self.node, "persistent_state")
        # Journal machinery (durable roles only): inbound records pend in
        # memory and hit the file right before the first send they cause.
        self._wal_pending: List[bytes] = []
        self._wal_fh = None
        # Snapshot compaction policy: the journal is the durability
        # barrier, so the O(state) snapshot only needs to be taken when
        # the journal has grown past ``wal_max_bytes`` or every
        # ``persist_interval`` seconds — never on the hot path.
        self.persist_interval = persist_interval
        self.wal_max_bytes = wal_max_bytes
        self._wal_bytes = 0
        self._last_persist = time.monotonic()
        self.checkpoints = 0
        self.wal_appends = 0

    # -- lifecycle ---------------------------------------------------------
    def run(self, duration: float = 3600.0) -> None:
        node = self.node
        disk_lost = False
        if self.recover:
            if self.state_path.exists() or self.wal_path.exists():
                # Snapshot + journal replay, outbound I/O suppressed.
                self.replaying = True
                node.transport = self.transport
                try:
                    if self.state_path.exists():
                        snapshot = wire.decode_state(self.state_path.read_bytes())
                        if self.persists and snapshot.get("persistent") is not None:
                            node.load_persistent_state(snapshot["persistent"])
                    _replay_into(node, self.wal_path)
                finally:
                    self.replaying = False
                print(
                    f"[{self.addr}] recovered from {self.state_path} "
                    f"(+ journal)",
                    flush=True,
                )
            elif isinstance(node, Replica):
                # Restarted with no state file: the disk is gone (the
                # nemesis deleted it).  Re-sync the prefix from peers.
                print(f"[{self.addr}] state file missing: disk lost", flush=True)
                disk_lost = True
        self.transport.register(node)
        if disk_lost:
            node.lose_disk()
        elif isinstance(node, Replica) and (node._disk_lost or node._resync_pending):
            # A wipe (or an interrupted re-sync) recovered from the
            # journal: resume the peer re-sync live.
            node._resync()
        if self.persists:
            self._wal_fh = open(self.wal_path, "ab")
        # Replace the spawn preamble's provisional handler: from here on a
        # SIGTERM requests a graceful stop (flush + persist happen on the
        # loop-stop path).  Signal-safe: only sets a flag.
        signal.signal(signal.SIGTERM, lambda *a: self._request_shutdown())
        print(f"[{self.addr}] up (pid {os.getpid()})", flush=True)
        self.transport.run(duration, until=lambda: self._shutdown)
        print(f"[{self.addr}] clean exit", flush=True)

    def _request_shutdown(self) -> None:
        self._shutdown = True

    def on_loop_start(self, loop) -> None:
        loop.add_signal_handler(signal.SIGTERM, self._on_sigterm)
        self._arm_checkpoint()

    def on_loop_stopping(self) -> None:
        # Clean shutdown (SIGTERM or duration expiry): flush buffered
        # hot-path batches onto the wire — the nemesis' flush-vs-drop
        # contract — and persist the final snapshot while connections are
        # still drainable.
        print(f"[{self.addr}] stopping: flush + persist", flush=True)
        try:
            self.node.flush_batches()
        finally:
            self.persist()

    def _on_sigterm(self) -> None:
        print(f"[{self.addr}] SIGTERM", flush=True)
        self._shutdown = True

    def _arm_checkpoint(self) -> None:
        def tick() -> None:
            self.persist_if_dirty()
            if not self._shutdown:
                self.transport._call_later(self.checkpoint_interval, tick)

        self.transport._call_later(self.checkpoint_interval, tick)

    # -- durability --------------------------------------------------------
    def mark_dirty(self) -> None:
        self._dirty = True

    def on_inbound(self, src: Address, msg: Any) -> None:
        """Every inbound message marks the snapshot stale, and — for
        durable roles — is journaled (pending in memory; written ahead of
        the first send it causes).  CtlFault is transient network state
        and never journaled."""
        self._dirty = True
        if self.persists and not isinstance(msg, CtlFault):
            self._wal_pending.append(_wal_record(src, msg))

    def flush_wal(self) -> None:
        """The write-ahead barrier: the journal records justifying an
        outbound frame hit the disk before the frame hits the wire.
        Roles whose state the model calls volatile (proposer, router)
        skip this — their report rides the periodic checkpoint."""
        if self._wal_pending and self._wal_fh is not None:
            blob = b"".join(self._wal_pending)
            self._wal_fh.write(blob)
            self._wal_fh.flush()
            self.wal_appends += len(self._wal_pending)
            self._wal_bytes += len(blob)
            self._wal_pending.clear()

    def persist_if_dirty(self) -> None:
        """Checkpoint-tick policy: compact when the journal got big or
        the snapshot got old; durability never waits on this."""
        if self._dirty and (
            self._wal_bytes >= self.wal_max_bytes
            or time.monotonic() - self._last_persist >= self.persist_interval
        ):
            self.persist()

    def persist(self) -> None:
        """Checkpoint: write the O(state) snapshot, then truncate the
        journal it supersedes (pending records are absorbed too — the
        snapshot reflects every mutation to date).  A crash between the
        two writes only leaves extra journal records whose replay onto
        the newer snapshot is idempotent."""
        self._dirty = False
        snapshot = {
            "role": type(self.node).__name__,
            "persistent": self.node.persistent_state() if self.persists else None,
            "report": self.report(),
        }
        data = wire.encode_state(snapshot)
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.replace(self.state_path)
        self._wal_pending.clear()
        if self._wal_fh is not None:
            self._wal_fh.truncate(0)
            self._wal_fh.seek(0)
        self._wal_bytes = 0
        self._last_persist = time.monotonic()
        self.checkpoints += 1

    def report(self) -> Dict[str, Any]:
        """Teardown-time observations for the parent's global invariant
        check (NOT reloaded on restart — a proposer's learned log is
        volatile; it only feeds the oracle merge)."""
        node = self.node
        if isinstance(node, Proposer):
            return {
                "chosen_values": dict(node.chosen_values),
                "oracle": [
                    (slot, rec.value, rec.round, rec.by)
                    for slot, rec in node.oracle.chosen.items()
                ],
                "violations": list(node.oracle.violations),
            }
        return {}

    # -- control frames ----------------------------------------------------
    def maybe_handle_control(self, src: Address, msg: Any) -> bool:
        node = self.node
        if isinstance(msg, CtlBecomeLeader):
            if isinstance(node, Proposer) and not node.failed:
                node.become_leader(msg.config)
        elif isinstance(msg, CtlReconfigure):
            if (
                isinstance(node, Proposer)
                and node.is_leader
                and node.round is not None
            ):
                node.reconfigure(msg.config)
        elif isinstance(msg, CtlMMReconfigure):
            if isinstance(node, MMReconfigCoordinator) and node.phase == "idle":
                # The coordinator itself is the source of truth for the
                # currently-live set (its last completed m_new); msg.old
                # only seeds the very first reconfiguration.  The parent
                # can't know whether an earlier request was dropped by
                # the busy-guard, so it must not track the set itself.
                old = node.m_new or msg.old
                if tuple(sorted(old)) != tuple(sorted(msg.new)):
                    node.reconfigure(old, msg.new)
        elif isinstance(msg, CtlWipeDisk):
            if isinstance(node, Replica):
                node.lose_disk()
        elif isinstance(msg, CtlFault):
            self._apply_fault(msg)
        else:
            return False
        return True

    def _apply_fault(self, msg: CtlFault) -> None:
        plane = self.transport.faults
        if msg.op == "partition":
            side_a, side_b, symmetric = msg.payload
            plane.partition(side_a, side_b, symmetric=symmetric)
        elif msg.op == "storm":
            (storm,) = msg.payload
            plane.add_storm(storm)
        elif msg.op == "skew":
            addr, scale, offset = msg.payload
            plane.set_skew(addr, scale, offset)
        elif msg.op == "heal":
            plane.heal()


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="matchmaker-paxos proc-plane worker")
    p.add_argument("--addr", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=3600.0)
    p.add_argument("--recover", action="store_true")
    args = p.parse_args(argv)
    workdir = Path(args.workdir)
    manifest = pickle.loads((workdir / "spec.pkl").read_bytes())
    host = NodeHost(
        manifest["spec"],
        args.addr,
        workdir,
        seed=args.seed,
        recover=args.recover,
        net=manifest.get("net"),
    )
    try:
        host.run(duration=args.duration)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


# --------------------------------------------------------------------------
# Parent side: supervisor + transport + deployment facade
# --------------------------------------------------------------------------
class Supervisor:
    """Spawns and signals the per-node worker processes.

    Owns the workdir layout (``spec.pkl``, ``ports/``, ``state/``,
    ``logs/``, ``leaders``), the per-node log streams, and the
    shard-leader registry that parent clients and worker routers route
    through."""

    def __init__(
        self,
        spec: Any,
        workdir: Path,
        *,
        seed: int = 0,
        net: Optional[NetworkConfig] = None,
    ):
        self.spec = spec
        self.workdir = Path(workdir)
        self.seed = seed
        self.workdir.mkdir(parents=True, exist_ok=True)
        (self.workdir / "logs").mkdir(exist_ok=True)
        (self.workdir / "state").mkdir(exist_ok=True)
        # The worker manifest: topology + the network model every worker
        # applies to its own sends (callable-bearing NetworkConfig hooks
        # would fail to pickle here — loudly, by design).
        (self.workdir / "spec.pkl").write_bytes(
            pickle.dumps({"spec": spec, "net": net})
        )
        self.rendezvous = Rendezvous(self.workdir)
        self.addrs: Tuple[Address, ...] = worker_addrs(spec)
        self.procs: Dict[Address, subprocess.Popen] = {}
        self._logs: Dict[Address, Any] = {}
        self.expected_dead: set = set()
        self.paused: set = set()
        self._unexpected: Optional[List[Tuple[Address, int]]] = None
        self.leaders: Dict[int, Optional[Address]] = {}
        self._write_leaders()

    # -- leader registry ---------------------------------------------------
    def set_leader(self, shard: int, addr: Optional[Address]) -> None:
        self.leaders[shard] = addr
        self._write_leaders()

    def leader_of(self, shard: int) -> Optional[Address]:
        return self.leaders.get(shard)

    def _write_leaders(self) -> None:
        path = leaders_path(self.workdir)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(
            "".join(
                f"{s} {a}\n" for s, a in sorted(self.leaders.items()) if a
            )
        )
        tmp.replace(path)

    # -- spawning ----------------------------------------------------------
    def _env(self) -> Dict[str, str]:
        env = dict(os.environ)
        pkg_root = str(Path(__file__).resolve().parents[2])  # .../src
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        return env

    def spawn(self, addr: Address, *, recover: bool = False) -> None:
        assert addr not in self.procs or self.procs[addr].poll() is not None
        self.rendezvous.clear(addr)  # the fresh process publishes anew
        logf = self._logs.get(addr)
        if logf is None:
            logf = open(self.workdir / "logs" / f"{addr}.log", "ab", buffering=0)
            self._logs[addr] = logf
        # -c (not -m): running this module as __main__ would duplicate it
        # in sys.modules, and the worker's Ctl* classes must be identical
        # to the ones the parent pickles into control frames.  The
        # preamble installs a provisional SIGTERM handler *before* the
        # (slow) package import, so a clean-crash or teardown signal
        # landing mid-startup exits 0 (nothing served, nothing to flush)
        # instead of dying by signal; NodeHost.run replaces it with the
        # graceful flush+persist handler.
        cmd = [
            sys.executable,
            "-c",
            "import os, signal; "
            "signal.signal(signal.SIGTERM, lambda *a: os._exit(0)); "
            "import sys; from repro_torch.core.proc import worker_main; "
            "sys.exit(worker_main())",
            "--addr",
            addr,
            "--workdir",
            str(self.workdir),
            "--seed",
            str((self.seed * 1_000_003 + zlib.crc32(addr.encode())) & 0x7FFFFFFF),
        ]
        if recover:
            cmd.append("--recover")
        self.procs[addr] = subprocess.Popen(
            cmd, stdout=logf, stderr=subprocess.STDOUT, env=self._env()
        )
        self.expected_dead.discard(addr)
        self.paused.discard(addr)

    def spawn_all(self) -> None:
        for addr in self.addrs:
            self.spawn(addr)

    def wait_ready(self, timeout: float = 30.0) -> None:
        self.rendezvous.wait_all(self.addrs, timeout=timeout)

    # -- signals -----------------------------------------------------------
    def alive(self, addr: Address) -> bool:
        proc = self.procs.get(addr)
        return proc is not None and proc.poll() is None

    def _signal(self, addr: Address, sig: int) -> None:
        proc = self.procs.get(addr)
        if proc is not None and proc.poll() is None:
            try:
                os.kill(proc.pid, sig)
            except ProcessLookupError:
                pass

    def kill(self, addr: Address, *, clean: bool) -> None:
        """Crash a worker: SIGTERM (flush + persist) or SIGKILL."""
        self.expected_dead.add(addr)
        if addr in self.paused:
            # A stopped process can't run its SIGTERM handler; for a
            # clean crash, continue it first so the flush actually runs.
            self._signal(addr, signal.SIGCONT)
            self.paused.discard(addr)
        self._signal(addr, signal.SIGTERM if clean else signal.SIGKILL)
        # Withdraw the corpse's port publication: the OS may recycle the
        # ephemeral port, and a stale file would point senders at
        # whoever inherits it (the hello handshake also guards this).
        self.rendezvous.clear(addr)

    def respawn(self, addr: Address) -> None:
        proc = self.procs.get(addr)
        if proc is not None and proc.poll() is None:
            # Restart of a live process: take it down cleanly first.
            self.kill(addr, clean=True)
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self._signal(addr, signal.SIGKILL)
                proc.wait()
        self.spawn(addr, recover=True)

    def pause(self, addr: Address) -> None:
        self.paused.add(addr)
        self._signal(addr, signal.SIGSTOP)

    def resume(self, addr: Address) -> None:
        self.paused.discard(addr)
        self._signal(addr, signal.SIGCONT)

    # -- teardown ----------------------------------------------------------
    def shutdown(self, grace: float = 8.0) -> None:
        # Snapshot mid-run casualties first: terminations the shutdown
        # itself causes are never "unexpected".
        if self._unexpected is None:
            self._unexpected = self.unexpected_exits()
        for addr in list(self.paused):
            self._signal(addr, signal.SIGCONT)
        self.paused.clear()
        for addr in self.addrs:
            self.expected_dead.add(addr)
            if self.alive(addr):
                self._signal(addr, signal.SIGTERM)
        deadline = time.monotonic() + grace
        for addr, proc in self.procs.items():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self._signal(addr, signal.SIGKILL)
                    proc.wait()
        for logf in self._logs.values():
            try:
                logf.close()
            except Exception:
                pass
        self._logs.clear()

    def unexpected_exits(self) -> List[Tuple[Address, int]]:
        """Workers that died without the nemesis asking them to."""
        if self._unexpected is not None:
            return self._unexpected
        out = []
        for addr, proc in self.procs.items():
            code = proc.poll()
            if code is None:
                continue
            if addr in self.expected_dead:
                continue
            if code != 0:
                out.append((addr, code))
        return out

    def read_log(self, addr: Address, tail: int = 40) -> str:
        path = self.workdir / "logs" / f"{addr}.log"
        try:
            lines = path.read_text(errors="replace").splitlines()
        except OSError:
            return ""
        return "\n".join(lines[-tail:])

    def read_state(self, addr: Address) -> Optional[Dict[str, Any]]:
        path = self.workdir / "state" / f"{addr}.state"
        try:
            return wire.decode_state(path.read_bytes())
        except (OSError, ValueError):
            return None

    def __del__(self):  # best-effort: never leak OS processes
        try:
            for proc in self.procs.values():
                if proc.poll() is None:
                    proc.kill()
        except Exception:
            pass


class _NodeMap(dict):
    """ProcTransport.nodes: local (parent-hosted) nodes by address, with
    remote worker handles materializing on demand — the nemesis driver
    indexes ``transport.nodes[addr]`` without caring which side of the
    process boundary a node lives on."""

    def __init__(self, transport: "ProcTransport"):
        super().__init__()
        self.transport = transport

    def __missing__(self, addr: Address) -> "RemoteHandle":
        return self.transport.remote_handle(addr)


class RemoteHandle:
    """The parent's view of one worker process: liveness + the control
    actions the nemesis and the failure detector drive."""

    def __init__(self, transport: "ProcTransport", addr: Address, shard: int = 0):
        self.transport = transport
        self.addr = addr
        self.shard = shard

    @property
    def failed(self) -> bool:
        sup = self.transport.supervisor
        return sup is None or not sup.alive(self.addr)

    def become_leader(self, config: Configuration) -> None:
        self.transport.control(self.addr, CtlBecomeLeader(config))
        self.transport.supervisor.set_leader(self.shard, self.addr)

    def reconfigure(self, config: Configuration) -> None:
        self.transport.control(self.addr, CtlReconfigure(config))

    def lose_disk(self) -> None:
        sup = self.transport.supervisor
        if sup.alive(self.addr):
            self.transport.control(self.addr, CtlWipeDisk())
        else:
            # Dead victim: the wipe hits the disk directly (snapshot AND
            # journal); the respawn finds nothing and runs the peer
            # re-sync path.
            for suffix in (".state", ".wal"):
                try:
                    (sup.workdir / "state" / f"{self.addr}{suffix}").unlink()
                except FileNotFoundError:
                    pass


class ProcFaultPlane(FaultPlane):
    """The parent's FaultPlane with cluster-wide fan-out: every install
    (and heal) is applied locally — parent-hosted clients respect it —
    and broadcast as a CtlFault control frame to every worker's local
    plane.  Same declarative schedules, one plane per process.  Installs
    are also recorded on the transport's fault log so a worker spawned
    (or respawned) *after* an install receives the currently-active
    faults — a restarted process must rejoin the same partitioned
    network, exactly as on the in-process backends."""

    def __init__(self, transport: "ProcTransport"):
        super().__init__()
        self.transport = transport

    def _fan_out(self, msg: CtlFault) -> None:
        if msg.op == "heal":
            self.transport.fault_log.clear()
        else:
            self.transport.fault_log.append(msg)
        sup = self.transport.supervisor
        if sup is None:
            return
        for addr in sup.addrs:
            if sup.alive(addr):
                self.transport.control(addr, msg)

    def partition(self, side_a, side_b, *, symmetric: bool = True) -> None:
        super().partition(side_a, side_b, symmetric=symmetric)
        self._fan_out(
            CtlFault("partition", (tuple(side_a), tuple(side_b), symmetric))
        )

    def add_storm(self, storm: Storm) -> None:
        super().add_storm(storm)
        self._fan_out(CtlFault("storm", (storm,)))

    def set_skew(self, addr, scale: float = 1.0, offset: float = 0.0) -> None:
        super().set_skew(addr, scale, offset)
        self._fan_out(CtlFault("skew", (addr, scale, offset)))

    def heal(self) -> None:
        super().heal()
        self._fan_out(CtlFault("heal", ()))


class ProcTransport(_RendezvousTransport):
    """The parent process's transport: hosts the clients (and any other
    parent-resident nodes, e.g. a FailureDetector), resolves worker
    addresses through the rendezvous directory, and maps the nemesis
    control surface (crash / restart / pause / resume) onto real POSIX
    signals via the supervisor."""

    def __init__(self, seed: int = 0, net=None, *, workdir=None):
        super().__init__(seed=seed, net=net)
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="mmp-proc-"))
        self.rendezvous = Rendezvous(self.workdir)
        self.supervisor: Optional[Supervisor] = None
        self.nodes = _NodeMap(self)
        self._shards_of: Dict[Address, int] = {}
        # Currently-installed faults (ProcFaultPlane records installs,
        # heal clears): replayed to any worker spawned after the install.
        self.fault_log: List[CtlFault] = []

    def attach_supervisor(self, sup: Supervisor) -> None:
        self.supervisor = sup
        spec = sup.spec
        for s in range(max(1, spec.num_shards)):
            for a in spec.shard_proposer_addrs(s):
                self._shards_of[a] = s

    def remote_handle(self, addr: Address) -> RemoteHandle:
        return RemoteHandle(self, addr, self._shards_of.get(addr, 0))

    async def _on_loop_start(self) -> None:
        await super()._on_loop_start()
        # Control frames queued before the loop existed.
        for (src, dst) in list(self._outbox):
            self._pump(src, dst)

    def control(self, addr: Address, msg: Any) -> None:
        """Send a control frame to a worker, bypassing the modelled
        network (and any installed faults): the supervisor's channel is
        out-of-band, like a management network."""
        self._transmit(SUPERVISOR_ADDR, addr, msg)

    # -- nemesis surface: signals instead of flags -------------------------
    def _is_local(self, addr: Address) -> bool:
        return dict.__contains__(self.nodes, addr)

    def crash(self, addr: Address, *, clean: bool = False) -> None:
        if self._is_local(addr):
            dict.__getitem__(self.nodes, addr).crash(clean=clean)
            return
        self.supervisor.kill(addr, clean=clean)

    def restart(self, addr: Address, *, wipe_volatile: bool = True) -> None:
        # A process restart is always a fresh interpreter: volatile state
        # cannot survive, whatever the schedule asked for.  (The sim
        # backend covers the wipe_volatile=False thought experiment.)
        if self._is_local(addr):
            dict.__getitem__(self.nodes, addr).restart(wipe_volatile=wipe_volatile)
            return
        sup = self.supervisor

        def finish() -> None:
            sup.spawn(addr, recover=True)
            # The fresh process rejoins the same faulty network: replay
            # the currently-installed partitions/storms/skews.
            for msg in self.fault_log:
                self.control(addr, msg)

        if not sup.alive(addr):
            finish()
            return
        # Restarting a *live* worker: take it down cleanly, but never
        # block the event loop on its teardown — poll for the exit (with
        # a SIGKILL escalation) and spawn the successor when it is gone.
        sup.kill(addr, clean=True)
        deadline = time.monotonic() + 5.0

        def poll() -> None:
            if sup.alive(addr):
                if time.monotonic() > deadline:
                    sup.kill(addr, clean=False)
                self._call_later(0.02, poll)
                return
            finish()

        self._call_later(0.02, poll)

    def pause(self, addr: Address) -> None:
        if self._is_local(addr):
            super().pause(addr)
            return
        self.supervisor.pause(addr)

    def resume(self, addr: Address) -> None:
        if self._is_local(addr):
            super().resume(addr)
            return
        self.supervisor.resume(addr)


# --------------------------------------------------------------------------
# Deployment facade (the proc counterpart of deploy.Deployment)
# --------------------------------------------------------------------------
class _ShadowNode:
    """A minimal stand-in reconstructed from a persisted snapshot, shaped
    for nemesis.check_invariants."""

    def __init__(self, addr: Address, **attrs: Any):
        self.addr = addr
        for k, v in attrs.items():
            setattr(self, k, v)


class _ShadowDeployment:
    def __init__(self, oracle, f, sm_factory, proposers, acceptors, replicas, clients):
        self.oracle = oracle
        self.f = f
        self.sm_factory = sm_factory
        self.proposers = proposers
        self.acceptors = acceptors
        self.replicas = replicas
        self.clients = clients


class ProcDeployment:
    """Drives a multi-process cluster from the parent: clients, leader
    registry, nemesis actions, teardown and the global invariant check
    over the workers' persisted state."""

    def __init__(self, spec: Any, transport: ProcTransport, supervisor: Supervisor):
        self.spec = spec
        self.sim = transport  # the historical field name (nemesis binds it)
        self.supervisor = supervisor
        self.f = spec.f
        self.num_shards = max(1, spec.num_shards)
        self.sm_factory = spec.sm_factory
        self.clients: List[Client] = []
        self.config_seq = 0
        self.failover_log: List[Dict[str, Any]] = []

    # -- the Deployment facade the nemesis drives --------------------------
    @property
    def transport(self) -> ProcTransport:
        return self.sim

    def shard_proposers(self, shard: int = 0) -> List[RemoteHandle]:
        return [
            self.sim.remote_handle(a)
            for a in self.spec.shard_proposer_addrs(shard)
        ]

    def fresh_config(self, acceptor_addrs: Sequence[Address]) -> Configuration:
        self.config_seq += 1
        return Configuration.majority(self.config_seq, acceptor_addrs)

    def random_config(self, shard: int = 0) -> Configuration:
        n = 2 * self.f + 1
        pool = list(self.spec.shard_acceptor_addrs(shard))
        return self.fresh_config(sorted(self.sim.rng.sample(pool, n)))

    def reconfigure_random(self, shard: int = 0) -> None:
        leader = self.supervisor.leader_of(shard)
        if leader is None or not self.supervisor.alive(leader):
            return  # no stable leader right now; same guard as in-process
        self.sim.control(leader, CtlReconfigure(self.random_config(shard)))

    def reconfigure_matchmakers(self, new_addrs: Sequence[Address]) -> None:
        # ``old`` here is only the initial set; the mmcoord worker
        # substitutes its own last-completed set (it alone knows whether
        # a previous request was dropped by the one-at-a-time guard).
        self.sim.control(
            "mmcoord",
            CtlMMReconfigure(self.spec.matchmaker_addrs(), tuple(new_addrs)),
        )

    def start_clients(self) -> None:
        for c in self.clients:
            c.start()

    def stop_clients(self) -> None:
        for c in self.clients:
            c.stop()

    def latencies(self, t0: float = 0.0, t1: float = float("inf")) -> List[float]:
        return [
            lat
            for c in self.clients
            for (t, lat) in c.latencies
            if t0 <= t < t1
        ]

    # -- lifecycle ---------------------------------------------------------
    def elect_initial_leaders(self) -> None:
        """Shard s's proposer 0 takes over on the first 2f+1 acceptors of
        its pool — the proc form of ClusterSpec.auto_elect_leader."""
        for s in range(self.num_shards):
            props = self.spec.shard_proposer_addrs(s)
            accs = self.spec.shard_acceptor_addrs(s)[: 2 * self.f + 1]
            handle = self.sim.remote_handle(props[0])
            handle.become_leader(self.fresh_config(list(accs)))

    def attach_detector(
        self,
        *,
        ping_interval: float = 0.1,
        suspect_after: float = 0.4,
        confirm_misses: int = 2,
    ):
        """The ClusterController.attach_detector semantics over real OS
        processes: a parent-hosted heartbeat FailureDetector probes every
        shard's proposers over real sockets; a *confirmed* suspicion of a
        shard's current leader (e.g. it was SIGKILLed) promotes that
        shard's live follower with a real takeover — full Phase 1 on a
        fresh configuration — leaving every other shard untouched."""
        from repro_torch.coord.failure import FailureDetector

        targets = {
            f"proposer:{s}:{a}": (a,)
            for s in range(self.num_shards)
            for a in self.spec.shard_proposer_addrs(s)
        }

        def on_suspect(key: str) -> None:
            _, s_str, addr = key.split(":", 2)
            s = int(s_str)
            if self.supervisor.leader_of(s) != addr:
                return  # a silent follower needs no failover
            successor = next(
                (h for h in self.shard_proposers(s) if h.addr != addr and not h.failed),
                None,
            )
            if successor is None:
                return
            successor.become_leader(self.random_config(s))
            self.failover_log.append(
                {
                    "suspected": addr,
                    "shard": s,
                    "action": "shard_takeover",
                    "new_leader": successor.addr,
                }
            )

        detector = FailureDetector(
            "detector",
            targets,
            ping_interval=ping_interval,
            suspect_after=suspect_after,
            confirm_misses=confirm_misses,
            on_suspect=on_suspect,
        )
        self.sim.register(detector)
        return detector

    def shutdown(self) -> None:
        self.supervisor.shutdown()

    # -- teardown-time global invariant check ------------------------------
    def gather(self) -> Tuple[_ShadowDeployment, List[str]]:
        """Merge every worker's persisted state into a shadow deployment
        and run the full invariant suite over it.  Durable roles are
        reconstructed exactly as a respawned worker would reconstruct
        them (snapshot + journal replay via :func:`recover_node`) — and
        since their journal is written ahead of every reply, the merged
        view is conservative w.r.t. anything a client observed."""
        sup = self.supervisor
        violations: List[str] = []
        oracle = Oracle()

        def observe(slot, value, rnd, by) -> None:
            try:
                oracle.on_chosen(slot, value, rnd, 0.0, by)
            except SafetyViolation:
                pass  # recorded in oracle.violations

        proposers, acceptors, replicas = [], [], []
        spec = self.spec
        prop_addrs = set(spec.all_proposer_addrs())
        acc_addrs = set(spec.all_acceptor_addrs())
        rep_addrs = set(spec.replica_addrs())
        for addr in sup.addrs:
            if addr in acc_addrs or addr in rep_addrs:
                try:
                    node = recover_node(spec, addr, sup.workdir)
                except Exception as exc:
                    violations.append(
                        f"harness: could not recover {addr}'s persisted "
                        f"state: {exc!r}"
                    )
                    continue
                if addr in acc_addrs:
                    acceptors.append(
                        _ShadowNode(addr, chosen_watermark=node.chosen_watermark)
                    )
                else:
                    replicas.append(
                        _ShadowNode(
                            addr,
                            log=dict(node.log),
                            exec_watermark=node.exec_watermark,
                        )
                    )
                continue
            if addr not in prop_addrs:
                continue  # matchmakers/router/mmcoord: no invariant surface
            snap = sup.read_state(addr)
            if snap is None:
                proposers.append(_ShadowNode(addr, chosen_values={}))
                continue
            report = snap.get("report") or {}
            proposers.append(
                _ShadowNode(addr, chosen_values=report.get("chosen_values", {}))
            )
            for slot, value, rnd, by in report.get("oracle", ()):
                observe(slot, value, rnd, by)
            for v in report.get("violations", ()):
                violations.append(f"worker {addr} oracle: {v}")
        # Replica logs are persisted-before-reply, so they are chosen
        # records in their own right — merge them into the oracle too.
        for r in replicas:
            for slot, value in r.log.items():
                observe(slot, value, None, f"replica:{r.addr}")
        violations.extend(oracle.violations)
        shadow = _ShadowDeployment(
            oracle=oracle,
            f=self.f,
            sm_factory=self.sm_factory,
            proposers=proposers,
            acceptors=acceptors,
            replicas=replicas,
            clients=self.clients,
        )
        violations.extend(check_invariants(shadow))
        for addr, code in sup.unexpected_exits():
            violations.append(
                f"harness: worker {addr} exited unexpectedly with code {code}; "
                f"log tail:\n{sup.read_log(addr)}"
            )
        # de-dup, preserving order
        seen = set()
        out = []
        for v in violations:
            if v not in seen:
                seen.add(v)
                out.append(v)
        return shadow, out


# --------------------------------------------------------------------------
# Deploy surface
# --------------------------------------------------------------------------
def deploy_proc(
    spec: Any,
    *,
    seed: int = 0,
    net: Optional[NetworkConfig] = None,
    workdir=None,
) -> Tuple[ProcTransport, ProcDeployment]:
    """The ``ClusterSpec.deploy(backend="proc")`` implementation: spawn
    one OS process per node, rendezvous their ports, build the parent's
    clients, and schedule the initial per-shard elections.  Returns
    ``(transport, deployment)``; drive with ``transport.run(...)`` and
    tear down with ``deployment.shutdown()``."""
    transport = ProcTransport(seed=seed, net=net, workdir=workdir)
    sup = Supervisor(spec, transport.workdir, seed=seed, net=net)
    transport.attach_supervisor(sup)
    dep = ProcDeployment(spec, transport, sup)

    S = max(1, spec.num_shards)
    run = getattr(spec, "shard_affinity_run", 1)
    if spec.route_via_router:
        leader_provider = lambda: spec.router_addr()  # noqa: E731
        route = None
    elif S > 1:
        leader_provider = lambda: sup.leader_of(0)  # noqa: E731
        route = lambda cid: sup.leader_of(shard_of_command(cid, S, run))  # noqa: E731
    else:
        leader_provider = lambda: sup.leader_of(0)  # noqa: E731
        route = None
    opts = spec.options or Options()
    client_batch = (
        opts.batch_policy(sealed=True)
        if getattr(spec, "client_coalesce", False)
        else None
    )
    for i in range(spec.n_clients):
        client = Client(
            f"c{i}",
            leader_provider,
            think_time=spec.client_think_time,
            max_commands=spec.client_max_commands,
            retry_timeout=spec.client_retry_timeout,
            route=route,
            batch=client_batch,
        )
        transport.register(client)
        dep.clients.append(client)

    sup.spawn_all()
    sup.wait_ready()
    if spec.auto_elect_leader:
        dep.elect_initial_leaders()
    return transport, dep


def run_proc_scenario(name: str, seed: int, *, schedule=None):
    """Run one adversarial scenario with every node as its own OS process
    and nemesis faults delivered as real signals.  Event times (and the
    throughput windows) are stretched by ``PROC_TIME_SCALE`` — process
    spawn and respawn cost real wall time.  Invariants are checked at
    teardown over the workers' persisted state (see module docstring)."""
    from .nemesis import Event, Schedule
    from .scenarios import _BUILDERS, _kv_op_factory, ScenarioResult

    if name == "fast_paxos_recovery":
        raise ValueError(
            "fast_paxos_recovery wires a bespoke in-process topology; "
            "use proc_scenario_names() for the proc matrix"
        )
    sc = _BUILDERS[name](seed)
    base = schedule if schedule is not None else sc.schedule
    k = PROC_TIME_SCALE
    stretched = Schedule(
        base.name, base.seed, tuple(Event(e.at * k, e.fault) for e in base.events)
    )

    transport, dep = deploy_proc(sc.cluster, seed=seed, net=sc.net)
    try:
        for i, c in enumerate(dep.clients):
            c.op_factory = _kv_op_factory(i)
        plane = ProcFaultPlane(transport)
        nem = Nemesis(dep, stretched, check=None, plane=plane)
        nem.arm()
        transport.run(sc.horizon * k)
        dep.stop_clients()
        dep.shutdown()
        shadow, violations = dep.gather()
    finally:
        dep.shutdown()  # idempotent; never leak processes

    lat = dep.latencies
    s0, s1 = (t * k for t in sc.steady_window)
    f0, f1 = (t * k for t in sc.faulty_window)
    return ScenarioResult(
        name=name,
        seed=seed,
        transport="proc",
        replay=nem.replay_line(),
        event_log=list(nem.event_log),
        violations=violations,
        chosen_slots=len(shadow.oracle.chosen),
        completed_commands=sum(len(c.latencies) for c in dep.clients),
        steady_throughput=len(lat(s0, s1)) / max(s1 - s0, 1e-9),
        faulty_throughput=len(lat(f0, f1)) / max(f1 - f0, 1e-9),
    )


if __name__ == "__main__":
    sys.exit(worker_main())
