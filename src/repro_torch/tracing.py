"""Spans and counters inside the port: one tracer, one clock.

Spans
-----
A span marks a stretch of work at a layer boundary::

    with tracing.span("step.replay", {"kind": "decode"}):
        graph.replay()

The port opens these spans:

* ``engine.generate``: a whole ``Engine.generate`` call, the root of its
  spans (attributes ``B``, ``prompt``, ``n_steps``);
* ``engine.sample``: each step's sampling on the host side: the ``argmax`` or
  ``multinomial``, the tokens' copy to the host, the EOS check and their
  layout for the next step;
* ``step.capture``: a captured step's first call for its layout, the eager
  step and the capture (on the CPU, the first, uncaptured call); attribute
  ``kind``, ``prefill`` or ``decode``;
* ``step.replay``: each later call of that step: the graph's replay (on the
  CPU, the uncaptured step); attribute ``kind``;
* ``train.step``: a whole train step, the root of its spans;
* ``train.grad``: each microbatch's gradient and its bf16 accumulation
  (attribute ``i``, the microbatch);
* ``train.update``: the optimizer's update.

Each span records its name, an id, the id of the span open around it
(``parent``), the id of its root span (``call``: every span of one
``generate`` call or train step shares it), its attributes, its start and
end on the host (``time.perf_counter``) and, on CUDA, on the device: a
``torch.cuda.Event(enable_timing=True)`` recorded on the current stream at
each end.  Spans are kept in memory; nothing synchronises while they are
recorded.  ``drain()`` synchronises once, resolves the events and returns
the spans, in the order they ended; ``summary`` gives each name's count and
median times.  While a ``torch.profiler`` runs, each
span also opens ``record_function("repro_torch.<name>")``, so a profiled
stretch shows the spans beside the kernels on the profiler's clock.

One clock: ``enable()`` synchronises the device, reads ``perf_counter`` and
records an anchor event on the idle stream, then polls the anchor until it
has run.  Every host and device time of a span is in seconds from that
moment, so a gap on the device is read against the host spans that ran
across it.  The anchor runs between the host's reading and the end of the
poll; that stretch (``anchor_error_s``: the record call, the device
reaching the event, the last poll; up to a few hundred microseconds)
bounds the error between the two clocks' origins.

Cost: off (the default), ``span`` is one check of a module-level flag that
returns a shared no-op context: no span, no event, no profiler range.  The
per-step spans pass a prebuilt attribute dict or none, so a decode step
builds no object for tracing; a ``generate`` call builds one dict, its
root's attributes.  On, a span costs a span object, two events recorded
and two ``perf_counter`` reads (microseconds of host time, a few hundred
nanoseconds of device time); the spans are held until ``drain``.  The
tracer is for one thread of one process; on a mesh every rank traces its
own, and nothing is exchanged between ranks.

Counters
--------
Always on, each an add on a cold path or once a replay, in ``COUNTERS``:

* ``captures.prefill``, ``captures.decode``: first calls of a layout
  (``step.capture``);
* ``capture_s.prefill``, ``capture_s.decode``: their host seconds, the eager
  step and the capture (the capture's synchronise waits for the eager
  step's device work);
* ``replays.prefill``, ``replays.decode``: later calls (``step.replay``);
* ``prefill_evictions``: captured prefills that a new batch layout replaced
  (an Engine holds one).

``counters()`` snapshots them with the kernel wrappers' launch counts,
``kernels.ops.LAUNCHES`` (as ``launches.<op>``) and ``LAUNCH_SHAPES`` (as
``launch_shapes.<op>.<shape>``), which stay where they are.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

COUNTERS: Dict[str, float] = dict.fromkeys(
    ("captures.prefill", "captures.decode", "capture_s.prefill", "capture_s.decode",
     "replays.prefill", "replays.decode", "prefill_evictions"), 0)

ON = False  # spans are recorded only while on

_ids = itertools.count(1)
_open: List["Span"] = []  # the spans open now, innermost last
_done: List["Span"] = []  # the spans ended since enable() or the last drain()
_origin = 0.0  # perf_counter() at the anchor
_anchor: Optional[torch.cuda.Event] = None  # None off the card
anchor_error_s = 0.0


def count(name: str, n: float = 1) -> None:
    COUNTERS[name] += n


def counters() -> Dict[str, float]:
    """A snapshot of every counter, the kernel wrappers' launches included."""
    from .kernels import ops  # the port's own module; it imports no tracing

    out = dict(COUNTERS)
    out.update((f"launches.{k}", n) for k, n in ops.LAUNCHES.items())
    out.update((f"launch_shapes.{op}.{shape}", n) for (op, shape), n in ops.LAUNCH_SHAPES.items())
    return out


class _Off:
    """The span of a tracer that is off: a shared context that does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One recorded span; after ``drain`` its times are resolved.

    ``host`` and ``device`` are (start, end) in seconds from the anchor;
    ``device`` is None off the card."""

    __slots__ = ("name", "id", "parent", "call", "attrs", "host", "device", "_events", "_range")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name, self.attrs = name, attrs or {}
        self.host: Tuple[float, float] = (0.0, 0.0)
        self.device: Optional[Tuple[float, float]] = None
        self._events: Optional[tuple] = None
        self._range = None

    def __enter__(self) -> "Span":
        self.id = next(_ids)
        outer = _open[-1] if _open else None
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        _open.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function("repro_torch." + self.name)
            self._range.__enter__()
        start = time.perf_counter()
        if _anchor is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.host = (start - _origin, 0.0)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        self.host = (self.host[0], time.perf_counter() - _origin)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.pop()  # spans nest: this one is the innermost
        _done.append(self)
        return False


def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """A span named ``name`` with ``attrs`` while the tracer is on; the
    shared no-op context while it is off."""
    if not ON:
        return _OFF
    return Span(name, attrs)


def enable() -> None:
    """Starts a trace: drops the spans not drained and sets the anchor (on
    CUDA, when the process has a CUDA context) from which every time is
    read."""
    global ON, _origin, _anchor, anchor_error_s
    _done.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        _anchor = torch.cuda.Event(enable_timing=True)
        _origin = time.perf_counter()
        _anchor.record()
        while not _anchor.query():  # a spin wakes sooner than a synchronise
            pass
        anchor_error_s = time.perf_counter() - _origin
    else:
        _anchor, _origin, anchor_error_s = None, time.perf_counter(), 0.0
    ON = True


def disable() -> None:
    """Stops recording; the spans recorded stay until ``drain``."""
    global ON
    ON = False


@contextlib.contextmanager
def traced():
    """``enable()`` on entry, ``disable()`` on exit."""
    enable()
    try:
        yield
    finally:
        disable()


def drain() -> List[Span]:
    """The spans ended since ``enable()`` or the last ``drain``, their times
    resolved (one synchronise on CUDA); the tracer forgets them."""
    spans = list(_done)
    _done.clear()
    if _anchor is not None and any(s._events is not None for s in spans):
        torch.cuda.synchronize()
        for s in spans:
            if s._events is not None:
                a, b = s._events
                s.device = (_anchor.elapsed_time(a) / 1e3, _anchor.elapsed_time(b) / 1e3)
                s._events = None
    return spans


def summary(spans: List[Span]) -> Dict[str, Tuple[int, float, Optional[float]]]:
    """(count, median host seconds, median device seconds or None off the
    card) of each span name (a captured step's as ``<name>.<kind>``), in
    the order the names first ended."""
    groups: Dict[str, List[Span]] = {}
    for s in spans:
        name = f"{s.name}.{s.attrs['kind']}" if "kind" in s.attrs else s.name
        groups.setdefault(name, []).append(s)
    out = {}
    for name, group in groups.items():
        dev = [s.device[1] - s.device[0] for s in group if s.device is not None]
        out[name] = (len(group), statistics.median(s.host[1] - s.host[0] for s in group),
                     statistics.median(dev) if dev else None)
    return out
