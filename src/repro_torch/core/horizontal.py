"""MultiPaxos with *horizontal* reconfiguration — the paper's baseline.

Section 7.2 / Figure 8: to reconfigure from acceptor set ``N`` to ``N'``,
the leader gets the value ``N'`` chosen in the log at some index ``i``; all
log entries >= ``i + alpha`` are chosen using ``N'``.  The leader may have at
most ``alpha`` unchosen commands outstanding (commands beyond the window are
queued — the "limits concurrency" drawback the paper discusses in Section 9).

This is the comparison system of Figure 10: it reconfigures without
performance degradation too, as long as alpha >= the number of outstanding
clients.  It exists so ``benchmarks/bench_horizontal.py`` can reproduce that
figure and so tests can contrast the two designs.

The acceptors are the plain Matchmaker Paxos acceptors (Algorithm 2) — a
horizontal deployment draws them from a fixed pool and activates subsets of
the pool via chosen ``ConfigChange`` log entries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from . import messages as m
from .log import CommandLog, SlotState
from .oracle import Oracle
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import on
from .sim import Address, Node


@dataclass(frozen=True)
class ConfigChange:
    """A configuration value chosen in the log (Figure 8's ``C1``, ``C2``)."""

    config: Configuration

    def __repr__(self) -> str:
        return f"ConfigChange({self.config!r})"


# The horizontal baseline shares the proposer-side slot bookkeeping
# (core/log.py); ``HSlotState`` remains as the historical alias.
HSlotState = SlotState


class HorizontalProposer(Node):
    """A MultiPaxos leader with the alpha-window reconfiguration scheme."""

    def __init__(
        self,
        addr: Address,
        proposer_id: int,
        *,
        replicas: Tuple[Address, ...],
        initial_config: Configuration,
        oracle: Optional[Oracle] = None,
        alpha: int = 8,
        thrifty: bool = True,
        retry_timeout: float = 0.25,
        f: int = 1,
    ):
        super().__init__(addr)
        self.pid = proposer_id
        self.replicas = replicas
        self.oracle = oracle or Oracle()
        self.alpha = alpha
        self.thrifty = thrifty
        self.retry_timeout = retry_timeout
        self.f = f

        self.is_leader = False
        self.round: Optional[Round] = None
        # configs[i] = configuration effective from log slot i onward.
        # Slot s uses the config with the largest effective slot <= s.
        self.configs: Dict[int, Configuration] = {0: initial_config}

        self.cmdlog = CommandLog()  # owns the whole log (single leader)
        self.queued: List[m.Command] = []
        # telemetry
        self.stall_count = 0
        self.reconfig_slots: List[int] = []

    # -- log views (historical field names) ----------------------------
    @property
    def slots(self) -> Dict[int, SlotState]:
        return self.cmdlog.slots

    @property
    def next_slot(self) -> int:
        return self.cmdlog.next_slot

    @property
    def chosen_values(self) -> Dict[int, Any]:
        return self.cmdlog.chosen_values

    @property
    def chosen_watermark(self) -> int:
        return self.cmdlog.chosen_watermark

    # ------------------------------------------------------------------
    def config_for_slot(self, slot: int) -> Configuration:
        eff = max(i for i in self.configs if i <= slot)
        return self.configs[eff]

    def become_leader(self) -> None:
        """Phase 1 over the *union* of active configurations.

        For the Figure 10 benchmark there is a single stable leader, so we
        keep takeover minimal: a fresh round + Phase 1 to the pool of every
        configuration currently in the window.
        """
        self.is_leader = True
        self.round = Round(0, self.pid, 0) if self.round is None else self.round.next_r(self.pid)
        pool = {a for c in self.configs.values() for a in c.acceptors}
        self.broadcast(tuple(sorted(pool)), m.Phase1A(round=self.round, from_slot=self.chosen_watermark))
        self._p1_acks: Set[Address] = set()
        self._p1_needed = pool
        self._steady = False

    def reconfigure(self, new_config: Configuration) -> None:
        """Chose ``ConfigChange(new_config)`` at slot i; effective at i+alpha."""
        assert self.is_leader
        slot = self._claim_slot()
        if slot is None:
            # Window full: a reconfiguration is itself subject to alpha.
            self.queued.append(ConfigChange(new_config))
            self.stall_count += 1
            return
        self.reconfig_slots.append(slot)
        self._propose_at(slot, ConfigChange(new_config))

    # ------------------------------------------------------------------
    # Phase1Nack / Phase2Nack are deliberately unhandled: single stable
    # leader in the baseline benchmark.
    @on(m.Chosen)
    def _on_chosen(self, src: Address, msg: m.Chosen) -> None:
        self._learn_chosen(msg.slot, msg.value, external=True)

    @on(m.Phase1B)
    def _on_phase1b(self, src: Address, msg: m.Phase1B) -> None:
        if self._steady or msg.round != self.round:
            return
        self._p1_acks.add(src)
        # Quorum per active configuration.
        for cfg in self.configs.values():
            if not cfg.phase1.is_quorum(self._p1_acks & set(cfg.acceptors)):
                return
        self._steady = True
        self._flush_queued()

    @on(m.ClientRequest)
    def _on_client_request(self, src: Address, msg: m.ClientRequest) -> None:
        if not self.is_leader or not self._steady:
            return
        cmd = msg.command
        for slot, st in self.slots.items():
            if isinstance(st.value, m.Command) and st.value.cmd_id == cmd.cmd_id:
                if st.chosen:
                    self.broadcast(self.replicas, m.Chosen(slot=slot, value=st.value))
                return
        slot = self._claim_slot()
        if slot is None:
            # "the MultiPaxos leader can process at most alpha unchosen
            # commands at a time" (Section 7.2).
            self.stall_count += 1
            self.queued.append(cmd)
            return
        self._propose_at(slot, cmd)

    def _claim_slot(self) -> Optional[int]:
        if self.cmdlog.in_flight() >= self.alpha:
            return None
        return self.cmdlog.claim()

    def _propose_at(self, slot: int, value: Any) -> None:
        cfg = self.config_for_slot(slot)
        st = SlotState(value=value, round=self.round, config=cfg)
        self.slots[slot] = st
        self._send_phase2a(slot, thrifty=self.thrifty)

    def _send_phase2a(self, slot: int, *, thrifty: bool) -> None:
        st = self.slots[slot]
        targets = st.config.phase2.sample(self.rng) if thrifty else st.config.acceptors
        for a in targets:
            self.send(a, m.Phase2A(round=st.round, slot=slot, value=st.value))

        def retry() -> None:
            cur = self.slots.get(slot)
            if cur is not None and not cur.chosen and self.is_leader:
                self._send_phase2a(slot, thrifty=False)

        self.set_timer(self.retry_timeout, retry)

    @on(m.Phase2B)
    def _on_phase2b(self, src: Address, msg: m.Phase2B) -> None:
        st = self.slots.get(msg.slot)
        if st is None or st.chosen or st.round != msg.round:
            return
        st.acks.add(src)
        if st.config.phase2.is_quorum(st.acks):
            self._learn_chosen(msg.slot, st.value)

    def _learn_chosen(self, slot: int, value: Any, external: bool = False) -> None:
        st = self.slots.get(slot)
        if st is not None and st.chosen:
            return
        if st is not None:
            st.chosen = True
        self.cmdlog.note_seen(slot)
        self.cmdlog.mark_chosen(slot, value)
        if isinstance(value, ConfigChange):
            # Figure 8: effective from slot + alpha.
            self.configs[slot + self.alpha] = value.config
        if not external:
            self.oracle.on_chosen(slot, value, self.round, self.now, self.addr)
            self.broadcast(self.replicas, m.Chosen(slot=slot, value=value))
        self._flush_queued()

    def _flush_queued(self) -> None:
        if not self._steady:
            return
        while self.queued and self.next_slot - self.chosen_watermark < self.alpha:
            item = self.queued.pop(0)
            slot = self._claim_slot()
            if slot is None:  # pragma: no cover - guarded by the while
                self.queued.insert(0, item)
                return
            if isinstance(item, ConfigChange):
                self.reconfig_slots.append(slot)
            self._propose_at(slot, item)
