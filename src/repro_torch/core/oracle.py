"""Global safety oracle.

Observes every "value chosen" event across the deployment and asserts the
consensus safety property the paper proves in Sections 3/5/6: at most one
value is chosen per instance (per log slot), across all rounds and all
configurations.  Also checks replica-log prefix consistency and collects
the telemetry the paper reports (configurations returned per matchmaking,
reconfiguration durations, GC latencies).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import messages as m


class SafetyViolation(AssertionError):
    pass


@dataclass
class ChosenRecord:
    value: Any
    round: Any
    time: float
    by: str


class Oracle:
    def __init__(self):
        self.chosen: Dict[int, ChosenRecord] = {}  # slot -> first chosen record
        self.violations: List[str] = []
        # telemetry
        self.matchmaking_history_sizes: List[int] = []
        self.reconfig_durations: List[float] = []
        self.gc_durations: List[float] = []
        self.reconfig_times: List[float] = []

    # -- hooks ---------------------------------------------------------------
    def on_chosen(self, slot: int, value: Any, rnd: Any, now: float, by: str) -> None:
        prev = self.chosen.get(slot)
        if prev is None:
            self.chosen[slot] = ChosenRecord(value, rnd, now, by)
            return
        if not _value_eq(prev.value, value):
            msg = (
                f"slot {slot}: {prev.value!r} chosen in round {prev.round} by "
                f"{prev.by}, but {value!r} chosen in round {rnd} by {by}"
            )
            self.violations.append(msg)
            raise SafetyViolation(msg)

    def on_matchmaking_complete(self, n_history_configs: int) -> None:
        self.matchmaking_history_sizes.append(n_history_configs)

    def on_reconfig_complete(self, started: float, finished: float) -> None:
        self.reconfig_durations.append(finished - started)
        self.reconfig_times.append(finished)

    def on_gc_complete(self, started: float, finished: float) -> None:
        self.gc_durations.append(finished - started)

    # -- checks ---------------------------------------------------------------
    def check_replicas(self, replicas) -> None:
        """All replica logs must agree on every slot they share."""
        logs = [r.log for r in replicas]
        for i, log_a in enumerate(logs):
            for log_b in logs[i + 1 :]:
                for slot in log_a.keys() & log_b.keys():
                    if not _value_eq(log_a[slot], log_b[slot]):
                        raise SafetyViolation(
                            f"replica divergence at slot {slot}: "
                            f"{log_a[slot]!r} vs {log_b[slot]!r}"
                        )

    def check_client_results(self, clients) -> None:
        """Each client command got exactly one result (at-most-once)."""
        for c in clients:
            for cmd_id, replies in c.replies_by_cmd.items():
                results = {repr(r.result) for r in replies}
                if len(results) > 1:
                    raise SafetyViolation(
                        f"command {cmd_id} observed divergent results {results}"
                    )

    def assert_safe(self) -> None:
        if self.violations:
            raise SafetyViolation("; ".join(self.violations))


def _value_eq(a: Any, b: Any) -> bool:
    if isinstance(a, m.Noop) and isinstance(b, m.Noop):
        return True
    return a == b
