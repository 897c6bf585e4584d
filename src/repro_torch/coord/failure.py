"""Heartbeat failure detection feeding reconfiguration proposals.

Pods answer Ping with Pong (the acceptor role already does); the detector
tracks last-response times and suspects pods only after
``confirm_misses`` *consecutive* probe rounds with no response — a
partitioned pod is not a dead pod, and a single missed round (one dropped
Pong, a transient partition) must not trigger a cluster reconfiguration.
Suspicion is withdrawn the moment a Pong arrives (partition healed).

The detector consumes transport-level liveness only: it never reads a
``failed`` flag or any other global state.  A pod is suspected because
the *network* stopped answering — whether the nemesis killed the process
(kill -9 / clean crash) or cut the link, the evidence is the same, and
the confirmation window plus un-suspect-on-Pong is what separates the
two.  ``ClusterController.attach_detector`` turns confirmed suspicions
into real ``reconfigure`` calls — the paper's "replace failed acceptors"
flow (Section 8.1: fail at 25s, reconfigure at 30s) driven by actual
crash events instead of synthetic flags.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import messages as m
from repro_torch.core.runtime import on
from repro_torch.core.sim import Address, Node


class FailureDetector(Node):
    def __init__(
        self,
        addr: Address,
        targets: Dict[str, Tuple[Address, ...]],  # pod -> probe addresses
        *,
        ping_interval: float = 0.05,
        suspect_after: float = 0.2,
        confirm_misses: int = 2,
        on_suspect: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
    ):
        super().__init__(addr)
        self.targets = {p: tuple(a) for p, a in targets.items()}
        self.ping_interval = ping_interval
        self.suspect_after = suspect_after
        self.confirm_misses = max(1, confirm_misses)
        self.on_suspect = on_suspect
        self.on_recover = on_recover
        self.last_seen: Dict[str, float] = {}
        self.miss_rounds: Dict[str, int] = {}
        self.suspected: Set[str] = set()
        self._nonce = 0
        self._addr_to_pod: Dict[Address, str] = {}
        for pod, addrs in self.targets.items():
            for a in addrs:
                self._addr_to_pod[a] = pod
        # telemetry
        self.false_positive_guard_hits = 0  # rounds past timeout, below confirm

    def on_start(self) -> None:
        # Grace from *registration time*: a detector started at t > 0 must
        # not instantly suspect the whole cluster.
        for pod in self.targets:
            self.last_seen[pod] = self.now
            self.miss_rounds[pod] = 0
        self._tick()

    def on_restart(self) -> None:
        # The probe timer died with the crash; restart with fresh grace.
        for pod in self.targets:
            self.last_seen[pod] = self.now
            self.miss_rounds[pod] = 0
        self._tick()

    def watch(self, pod: str, addrs: Tuple[Address, ...]) -> None:
        self.targets[pod] = tuple(addrs)
        for a in addrs:
            self._addr_to_pod[a] = pod
        self.last_seen[pod] = self.now
        self.miss_rounds[pod] = 0
        self.suspected.discard(pod)

    def unwatch(self, pod: str) -> None:
        self.targets.pop(pod, None)
        self.last_seen.pop(pod, None)
        self.miss_rounds.pop(pod, None)
        self.suspected.discard(pod)

    def _tick(self) -> None:
        self._nonce += 1
        for pod, addrs in self.targets.items():
            for a in addrs:
                self.send(a, m.Ping(self._nonce))
        for pod, seen in list(self.last_seen.items()):
            if pod not in self.targets or pod in self.suspected:
                continue
            if self.now - seen > self.suspect_after:
                self.miss_rounds[pod] = self.miss_rounds.get(pod, 0) + 1
                if self.miss_rounds[pod] >= self.confirm_misses:
                    self.suspected.add(pod)
                    if self.on_suspect is not None:
                        self.on_suspect(pod)
                else:
                    # Past the timeout but not yet confirmed: this is the
                    # partition-tolerance window (partitioned != dead).
                    self.false_positive_guard_hits += 1
            else:
                self.miss_rounds[pod] = 0
        self.set_timer(self.ping_interval, self._tick)

    @on(m.Pong)
    def _on_pong(self, src: Address, msg: m.Pong) -> None:
        pod = self._addr_to_pod.get(src)
        if pod is None:
            return
        self.last_seen[pod] = self.now
        self.miss_rounds[pod] = 0
        if pod in self.suspected:
            self.suspected.discard(pod)  # partition healed / pod restarted
            if self.on_recover is not None:
                self.on_recover(pod)
