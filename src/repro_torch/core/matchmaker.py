"""The matchmaker role (Algorithms 1 and 4, plus the Section 6 extensions).

A matchmaker maintains a log ``L`` of configurations indexed by round and a
garbage-collection watermark ``w``.  On ``MatchA(i, C_i)`` it returns the
history ``H_i`` of configurations in rounds less than ``i`` — unless it has
already promised a round >= i, in which case it nacks (the paper "ignores";
the nack is the liveness detail of Section 3.2's closing remark).

For matchmaker reconfiguration (Section 6) every matchmaker additionally:
  * answers ``StopA`` by freezing and returning its ``(L, w)``,
  * doubles as a single-decree Paxos *acceptor* used to choose the next
    matchmaker set, and
  * can be bootstrapped from a merged ``(L, w)`` and later enabled once its
    cohort has been chosen.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from . import messages as m
from .quorums import Configuration
from .rounds import NEG_INF, Round, max_round
from .runtime import on
from .sim import Address, Node


class Matchmaker(Node):
    def __init__(self, addr: Address, *, enabled: bool = True):
        super().__init__(addr)
        # Sharded log plane: each shard runs its own Matchmaking phase
        # against this shared matchmaker set, so (L, w) is kept per
        # shard, uniformly, shard 0 included.  The historical ``log`` /
        # ``gc_watermark`` names remain as shard-0 views below.
        self.shard_logs: Dict[int, Dict[Round, Configuration]] = {0: {}}
        self.shard_gc: Dict[int, Any] = {0: NEG_INF}
        self.stopped = False
        # A bootstrapped matchmaker may not process until its set is chosen.
        self.enabled = enabled
        self.bootstrapped = enabled
        # Section 6: single-decree Paxos acceptor state for choosing M_new.
        self.mm_ballot: Any = NEG_INF
        self.mm_vb: Any = NEG_INF
        self.mm_vv: Any = None
        # telemetry
        self.match_count = 0
        self.history_sizes = []

    # -- durability (proc plane) -------------------------------------------
    # Everything a matchmaker holds is persistent under the paper's
    # crash-recovery model: its configuration log L and GC watermark w
    # (per shard), the Section 6 freeze/bootstrap flags, and its
    # single-decree acceptor state for choosing M_new.  The proc worker
    # host persists this before any reply leaves the process.
    def persistent_state(self) -> Dict[str, Any]:
        return {
            "shard_logs": {s: dict(log) for s, log in self.shard_logs.items()},
            "shard_gc": dict(self.shard_gc),
            "stopped": self.stopped,
            "enabled": self.enabled,
            "bootstrapped": self.bootstrapped,
            "mm_ballot": self.mm_ballot,
            "mm_vb": self.mm_vb,
            "mm_vv": self.mm_vv,
        }

    def load_persistent_state(self, state: Dict[str, Any]) -> None:
        self.shard_logs = {s: dict(log) for s, log in state["shard_logs"].items()}
        self.shard_gc = dict(state["shard_gc"])
        self.stopped = state["stopped"]
        self.enabled = state["enabled"]
        self.bootstrapped = state["bootstrapped"]
        self.mm_ballot = state["mm_ballot"]
        self.mm_vb = state["mm_vb"]
        self.mm_vv = state["mm_vv"]

    # -- shard-0 views (historical field names; tests mutate these) --------
    @property
    def log(self) -> Dict[Round, Configuration]:
        return self.shard_logs.setdefault(0, {})

    @log.setter
    def log(self, value: Dict[Round, Configuration]) -> None:
        self.shard_logs[0] = value

    @property
    def gc_watermark(self) -> Any:
        return self.shard_gc.get(0, NEG_INF)

    @gc_watermark.setter
    def gc_watermark(self, w: Any) -> None:
        self.shard_gc[0] = w

    # -- helpers -----------------------------------------------------------
    def _log_for(self, shard: int) -> Dict[Round, Configuration]:
        return self.shard_logs.setdefault(shard, {})

    def _gc_for(self, shard: int) -> Any:
        return self.shard_gc.get(shard, NEG_INF)

    def _set_gc(self, shard: int, w: Any) -> None:
        self.shard_gc[shard] = w

    def _history_before(
        self, rnd: Round, shard: int = 0
    ) -> Tuple[Tuple[Round, Configuration], ...]:
        items = [(j, c) for j, c in self._log_for(shard).items() if j < rnd]
        items.sort(key=lambda jc: jc[0].key())
        return tuple(items)

    def snapshot(self) -> Tuple[Tuple[Round, Configuration], ...]:
        items = sorted(self.log.items(), key=lambda jc: jc[0].key())
        return tuple(items)

    def shard_snapshots(self) -> Tuple[m.ShardLogSnapshot, ...]:
        """Every shard > 0 as (shard, entries, gc_watermark) triples
        (shard 0 travels in StopB/Bootstrap's historical fields)."""
        out = []
        for s in sorted(set(self.shard_logs) | set(self.shard_gc)):
            if s == 0:
                continue
            entries = tuple(
                sorted(self.shard_logs.get(s, {}).items(), key=lambda jc: jc[0].key())
            )
            out.append((s, entries, self.shard_gc.get(s, NEG_INF)))
        return tuple(out)

    def _live(self) -> bool:
        """MatchA/GarbageA are only served by a live (un-stopped, enabled)
        matchmaker; control traffic below bypasses this gate."""
        return not self.stopped and self.enabled

    # -- message handling ----------------------------------------------------
    @on(m.StopA)
    def _on_stop_a(self, src: Address, msg: m.StopA) -> None:
        # Section 6: freeze.  StopA is answered even when already stopped
        # (idempotent) so that f+1 StopB responses can always be gathered.
        self.stopped = True
        self.send(
            src,
            m.StopB(
                log=self.snapshot(),
                gc_watermark=self.gc_watermark,
                shard_logs=self.shard_snapshots(),
            ),
        )

    @on(m.MMEnable)
    def _on_mm_enable(self, src: Address, msg: m.MMEnable) -> None:
        # Only meaningful after Bootstrap; the coordinator sends MMEnable
        # causally after our BootstrapAck, but the network may duplicate.
        if self.bootstrapped:
            self.enabled = True

    # -- Algorithm 4 ---------------------------------------------------------
    @on(m.MatchA)
    def _on_match_a(self, src: Address, msg: m.MatchA) -> None:
        if not self._live():
            return
        i, ci, shard = msg.round, msg.config, msg.shard
        log, gc_w = self._log_for(shard), self._gc_for(shard)
        if i < gc_w:
            self.send(src, m.MatchNack(round=i, witnessed=gc_w))
            return
        # Idempotent retransmission: same round, same configuration.
        if i in log and log[i].config_id == ci.config_id:
            self.send(
                src,
                m.MatchB(
                    round=i,
                    gc_watermark=gc_w,
                    history=self._history_before(i, shard),
                ),
            )
            return
        witnessed = [j for j in log if j >= i]
        if witnessed:
            self.send(src, m.MatchNack(round=i, witnessed=max(witnessed, key=lambda r: r.key())))
            return
        hist = self._history_before(i, shard)
        log[i] = ci
        self.match_count += 1
        self.history_sizes.append(len(hist))
        self.send(src, m.MatchB(round=i, gc_watermark=gc_w, history=hist))

    @on(m.GarbageA)
    def _on_garbage_a(self, src: Address, msg: m.GarbageA) -> None:
        if not self._live():
            return
        i, shard = msg.round, msg.shard
        log = self._log_for(shard)
        for j in [j for j in log if j < i]:
            del log[j]
        self._set_gc(shard, max_round(self._gc_for(shard), i))
        self.send(src, m.GarbageB(round=i))

    # -- Section 6: bootstrap ------------------------------------------------
    @on(m.Bootstrap)
    def _on_bootstrap(self, src: Address, msg: m.Bootstrap) -> None:
        if not self.bootstrapped or self.stopped:
            # Fresh node, or a previously-stopped matchmaker being recycled
            # into a new cohort: adopt the merged state wholesale.
            self.shard_logs = {0: {j: c for j, c in msg.log}}
            self.shard_gc = {0: msg.gc_watermark}
            for s, log, w in msg.shard_logs:
                self.shard_logs[s] = {j: c for j, c in log}
                self.shard_gc[s] = w
            self.bootstrapped = True
            self.stopped = False
            self.enabled = False  # awaits MMEnable (set is chosen first)
        self.send(src, m.BootstrapAck())

    # -- Section 6: Paxos acceptor for the next matchmaker set ---------------
    # These run even when the matchmaker is stopped: choosing M_new is
    # exactly what a stopped cohort is for.
    @on(m.MMP1A)
    def _on_mm_p1a(self, src: Address, msg: m.MMP1A) -> None:
        if msg.ballot > self.mm_ballot:
            self.mm_ballot = msg.ballot
            self.send(src, m.MMP1B(ballot=msg.ballot, vb=self.mm_vb, vv=self.mm_vv))
        else:
            self.send(src, m.MMNack(ballot=self.mm_ballot))

    @on(m.MMP2A)
    def _on_mm_p2a(self, src: Address, msg: m.MMP2A) -> None:
        if msg.ballot >= self.mm_ballot:
            self.mm_ballot = msg.ballot
            self.mm_vb = msg.ballot
            self.mm_vv = msg.value
            self.send(src, m.MMP2B(ballot=msg.ballot))
        else:
            self.send(src, m.MMNack(ballot=self.mm_ballot))
