"""What the program's own spans and counters (``repro_torch.tracing``) read in a run.

The first reader of a ``--trace 1`` run that asks for the spans drives one
more stretch with the tracer on, after the harness's traced call: a
serving cell one call of ``min(generate, 1 + trace_decode_steps)`` tokens
(``runner._generate("trace", ...)``), a training cell ``trace_steps`` steps
(``runner._step``, advancing ``next_step``).  The spans are drained once
and kept on the run.  This stretch reads and writes nothing that another
metric, the breakdown or the output check reads: those read the window,
the harness's traced call and the set-up's first steps, and the metrics
that read the spans come after the others in ``BENCHMARK.json``.

A device time is the span's CUDA events, on the tracer's one clock; off
the card a span has none and the device readers return None.  A program
without the tracer (no ``repro_torch.tracing``) reads nothing: every
reader here returns None.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def counter(name: str) -> Optional[float]:
    """A counter of the program's registry, or None without the tracer."""
    tracing = tracer()
    return None if tracing is None else tracing.COUNTERS[name]


def _drive(run, tracing) -> list:
    r, traffic = run.runner, run.cell.traffic
    r._sync()
    with tracing.traced():
        if traffic["kind"] == "closed_batches":
            r._generate("trace", min(r.G, 1 + traffic.get("trace_decode_steps", 4)))
        else:
            for _ in range(traffic.get("trace_steps", 2)):
                r._step(r.next_step)
                r.next_step += 1
    spans = tracing.drain()
    _tell(spans, tracing)
    return spans


def spans(run) -> Optional[list]:
    """The spans of the run's stretch under the tracer, driven at the first
    call; None without the tracer or without a traced run."""
    if not hasattr(run, "program_spans"):
        tracing = tracer()
        run.program_spans = None if tracing is None or run.trace is None else _drive(run, tracing)
    return run.program_spans


def device_s(span) -> Optional[float]:
    return None if span.device is None else span.device[1] - span.device[0]


def named(spans_, name: str, kind: Optional[str] = None) -> list:
    """The spans of ``name`` (and attribute ``kind``) in the order they began."""
    out = [s for s in spans_ if s.name == name and (kind is None or s.attrs.get("kind") == kind)]
    return sorted(out, key=lambda s: s.host[0])


def device_times(spans_, name: str, kind: Optional[str] = None) -> Optional[List[float]]:
    """The device seconds of each such span; None where there is none or
    one has no device time (off the card)."""
    times = [device_s(s) for s in named(spans_, name, kind)]
    return times if times and None not in times else None


def per_call(spans_, name: str) -> Optional[List[float]]:
    """Each root call's sum of its ``name`` spans' device seconds."""
    sums: Dict[int, float] = {}
    for s in named(spans_, name):
        if s.device is None:
            return None
        sums[s.call] = sums.get(s.call, 0.0) + device_s(s)
    return list(sums.values()) or None


def turnarounds(spans_) -> Optional[List[tuple]]:
    """(replay d's end to the sampling's end, that to replay d + 1's start)
    on the device's clock, in seconds, for each pair of successive decode
    replays of one call; the ``engine.sample`` between them is the one that
    ended between the two on the device."""
    replays = named(spans_, "step.replay", "decode")
    samples = [s for s in named(spans_, "engine.sample") if s.device is not None]
    if len(replays) < 2 or any(s.device is None for s in replays):
        return None
    out = []
    for a, b in zip(replays, replays[1:]):
        if a.call != b.call:
            continue
        ends = [s.device[1] for s in samples
                if s.call == a.call and a.device[1] <= s.device[1] <= b.device[0]]
        cut = ends[-1] if ends else a.device[1]
        out.append((cut - a.device[1], b.device[0] - cut))
    return out or None


def _tell(spans_, tracing) -> None:
    """Each span name's count and median host and device ms on stderr, and
    each decode replay's device ms: what an operator reads by hand."""
    say = lambda *parts: print("perfbench: spans:", *parts, file=sys.stderr, flush=True)
    say(f"anchor error {1e6 * tracing.anchor_error_s:.1f} us")
    for name, (n, host, dev) in tracing.summary(spans_).items():
        dev_ms = "-" if dev is None else f"{1e3 * dev:.4f}"
        say(f"{name} n={n} host_ms={1e3 * host:.4f} device_ms={dev_ms}")
    times = device_times(spans_, "step.replay", "decode")
    if times:
        say("decode replays device_ms " + " ".join(f"{1e3 * t:.3f}" for t in times))
