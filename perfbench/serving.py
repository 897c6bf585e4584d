"""What the serving metrics read from a closed-batch window and its traced call."""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import profiling


def tokens(window) -> int:
    """Tokens that reached the host inside the window, every row counted."""
    return sum(c.rows * len(c.arrivals) for c in window.calls)


def first_token_s(window) -> List[Tuple[int, float]]:
    """(rows, seconds from the call's start to its first token) of each call
    whose first token came inside the window."""
    return [(c.rows, c.arrivals[0] - c.start) for c in window.calls if c.arrivals]


def gaps_s(window) -> List[Tuple[int, int, float]]:
    """(rows, decode step index, seconds) of every gap between successive
    tokens of a call inside the window; gap d follows decode step d (index
    0 is the first decode step, at the prompt's length)."""
    return [(c.rows, d, b - a) for c in window.calls
            for d, (a, b) in enumerate(zip(c.arrivals, c.arrivals[1:]))]


def per_request(pairs) -> List[float]:
    """Each value counted once for each of its rows (requests)."""
    return [v for rows, v in pairs for _ in range(rows)]


def stretches(trace_record) -> Optional[dict]:
    """The traced call's prefill stretch (its start to the first decode
    step's entry) and each decode step's stretch (its entry to the next one's, the
    last to the call's return), in the profiler's seconds; a step's device
    work lies inside its stretch, since the next step is entered only
    after the host has read this step's token."""
    tr = trace_record["trace"]
    call = profiling.first(tr, "perfbench.generate")
    entries = [a for a, _ in tr.ranges.get("perfbench.decode", [])]
    if call is None or not entries:
        return None
    ends = entries[1:] + [call[1]]
    return {"prefill": (call[0], entries[0]), "steps": list(zip(entries, ends))}


def timed_steps(trace_record, kind: str) -> List[Tuple[float, float]]:
    """(entry, return) of each captured step of ``kind`` in the event-timed
    call, seconds from its start; [] where there is none (off the card)."""
    timed = trace_record.get("timed") if trace_record else None
    return [(a, b) for k, a, b in (timed or {}).get("steps", []) if k == kind]
