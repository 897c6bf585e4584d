"""Closed loop of batches through ``Engine.generate``: the next call is sent
when the last returns.

Parameters (the mix's file): ``batch`` rows of ``prompt`` tokens each,
uniform over the vocabulary; ``generate`` tokens a row, greedy, no EOS;
``check_requests`` requests sampled for the output check;
``trace_decode_steps`` decode steps in the traced stretches of a
``--trace 1`` run.

Each token's arrival on the host is timed from the harness's side:
``generate`` calls the decode step after each token's copy to the host (the
last token's too), so a class-level wrapper of ``CapturedDecode.__call__``
reads the clock at each step's entry.  The wrapper also ends a call that is
still running when the window closes, at its next step.  A call finished in
the window is one that returned inside it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import outputs, profiling, program, seeded


RESEEDS = True  # calibrate.py may draw another seed's weights into one set-up


class WindowClosed(Exception):
    """Raised inside a ``generate`` call that the window's end cuts."""


@dataclass
class Call:
    k: int
    start: float
    rows: int
    arrivals: List[float] = field(default_factory=list)  # host times of its tokens
    tokens: Optional[np.ndarray] = None  # (rows, generate), a finished call's
    failed: bool = False


@dataclass
class Window:
    t0: float
    t1: float
    calls: List[Call]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Clock:
    """The arrivals of the call in flight, the window's end, and the CUDA
    events of an event-timed call."""

    def __init__(self):
        self.arrivals: Optional[List[float]] = None
        self.deadline = float("inf")
        self.marks: Optional[List[tuple]] = None  # (kind, event in, event out) a step

    @contextlib.contextmanager
    def marked(self, kind: str):
        """CUDA events at a captured step's entry and return, while ``marks``
        is a list."""
        if self.marks is None:
            yield
            return
        enter, leave = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        enter.record()
        yield
        leave.record()
        self.marks.append((kind, enter, leave))

    def token(self) -> None:
        now = time.perf_counter()
        if self.arrivals is None:
            return
        if now >= self.deadline:
            raise WindowClosed
        self.arrivals.append(now)


@contextlib.contextmanager
def _wrapped(clock: _Clock):
    """The captured steps' ``__call__`` wrapped at class level: the decode
    step reads the clock and is marked ``perfbench.decode``; the prefill
    (``CapturedStep``) is marked ``perfbench.prefill``; both are timed by
    CUDA events in an event-timed call."""
    from repro_torch.serve.graph import CapturedDecode, CapturedStep

    decode, prefill = CapturedDecode.__call__, CapturedStep.__call__

    def timed_decode(step, state, tokens):
        clock.token()
        with record_function("perfbench.decode"), clock.marked("decode"):
            return decode(step, state, tokens)

    def marked_prefill(step, inputs):
        with record_function("perfbench.prefill"), clock.marked("prefill"):
            return prefill(step, inputs)

    CapturedDecode.__call__, CapturedStep.__call__ = timed_decode, marked_prefill
    try:
        yield
    finally:
        CapturedDecode.__call__, CapturedStep.__call__ = decode, prefill


class Runner:
    def __init__(self, bench, cell, seed: int, device):
        self.bench, self.cell, self.seed, self.device = bench, cell, seed, torch.device(device)
        t = cell.traffic
        self.B, self.P, self.G = t["batch"], t["prompt"], t["generate"]
        self.cfg = program.model_config(cell.config)
        self.clock = _Clock()
        self._stack = contextlib.ExitStack()
        self.window_record: Optional[Window] = None
        self.trace_record: Optional[Dict[str, Any]] = None

    # -- the program -----------------------------------------------------------
    def prompts(self, k) -> torch.Tensor:
        return seeded.prompts(self.seed, k, self.B, self.P, self.cfg.vocab, self.device)

    def _generate(self, k, steps: int):
        with record_function("perfbench.generate"):
            return self.engine.generate({"tokens": self.prompts(k)}, steps)

    def setup(self) -> None:
        """The model from the seed, the Engine, and its two steps captured
        for this cell's layout: two short calls on a warm-up batch."""
        from repro_torch.serve import Engine

        t0 = time.perf_counter()
        self._stack.enter_context(_wrapped(self.clock))
        self.model = program.build_model(self.cell.config, self.seed, self.device)
        self.layouts = program.leaf_layouts(self.model)
        self._sync()
        t1 = time.perf_counter()
        self.engine = Engine(self.model, max_len=self.P + self.G + 1, device=self.device)
        for _ in range(2):
            self._generate("warm-up", min(self.G, 3))
        self._sync()
        self.laps = {"weights": t1 - t0, "capture and warm-up": time.perf_counter() - t1}

    def reseed(self, seed: int) -> None:
        """Another seed's weights drawn into the same model (the captured
        steps read the same tensors) and its prompts from then on."""
        self.seed = seed
        seeded.fill_module(self.model, self.cell.config["init"], seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Window:
        """Calls, one after another, until ``seconds`` have passed; the call
        in flight then is cut at its next step."""
        calls: List[Call] = []
        t0 = time.perf_counter()
        self.clock.deadline = t0 + seconds
        k = 0
        while time.perf_counter() < self.clock.deadline:
            call = Call(k=k, start=time.perf_counter(), rows=self.B)
            self.clock.arrivals = call.arrivals
            try:
                result = self._generate(k, self.G)
                if time.perf_counter() < self.clock.deadline:
                    call.tokens = result.tokens
                    call.failed = (result.tokens.shape != (self.B, self.G)
                                   or result.tokens.min() < 0
                                   or result.tokens.max() >= self.cfg.vocab)
            except WindowClosed:
                pass
            calls.append(call)
            k += 1
        self.clock.arrivals, self.clock.deadline = None, float("inf")
        self.window_record = Window(t0=t0, t1=t0 + seconds, calls=calls)
        return self.window_record

    def timed(self, steps: int) -> Optional[Dict[str, Any]]:
        """One call of ``steps`` tokens, not profiled, with CUDA events at its
        start and end and around each captured step: its ``end`` and each
        step's (kind, entry, return) in seconds of the device's clock from
        the call's start.  None off the card."""
        if self.device.type != "cuda":
            return None
        self._sync()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        self.clock.marks = []
        start.record()
        self._generate("trace", steps)
        end.record()
        self._sync()
        marks, self.clock.marks = self.clock.marks, None
        return {"end": start.elapsed_time(end) / 1e3,
                "steps": [(kind, start.elapsed_time(a) / 1e3, start.elapsed_time(b) / 1e3)
                          for kind, a, b in marks]}

    def trace(self, lead_s: float = 0.02) -> Dict[str, Any]:
        """One call of 1 + ``trace_decode_steps`` tokens timed by CUDA events
        (``timed``), then the same call under the profiler (after ``lead_s``
        inside it: the trace drops a window's first kernels), with the
        wrappers' launch counts around it."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels import ops

        steps = min(self.G, 1 + self.cell.traffic.get("trace_decode_steps", 4))
        timed = self.timed(steps)
        self._sync()
        before = dict(ops.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead_s)
            self._generate("trace", steps)
            self._sync()
        launches = {k: ops.LAUNCHES[k] - before.get(k, 0) for k in ops.LAUNCHES}
        self.trace_record = {"trace": profiling.read(prof), "launches": launches,
                             "decode_steps": steps - 1, "timed": timed}
        return self.trace_record

    def release(self) -> None:
        """Frees the program's state: the Engine, its graphs and the model."""
        self._stack.close()
        self.engine = self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the output check ------------------------------------------------------
    def sample(self) -> List[tuple]:
        """(call, row) of ``check_requests`` finished requests: the first
        finished calls' rows in turn, each call's rows in an order drawn from
        the seed (so a sample depends on the seed, not on how many calls the
        window finished, once it finished that many)."""
        done = [c for c in self.window_record.calls if c.tokens is not None]
        want = self.cell.traffic["check_requests"]
        use = done[:want]
        if not use:
            return []
        orders = [torch.randperm(c.rows, generator=torch.Generator().manual_seed(
            seeded.sub_seed(self.seed, "sample", c.k))).tolist() for c in use]
        picks = [(use[j % len(use)], orders[j % len(use)][j // len(use)])
                 for j in range(min(want, sum(c.rows for c in use)))]
        return sorted(picks, key=lambda p: (p[0].k, p[1]))

    def requests(self, picks) -> torch.Tensor:
        rows = []
        for call, r in picks:
            prompt = self.prompts(call.k)[r]
            served = torch.as_tensor(call.tokens[r], device=self.device)
            rows.append(torch.cat([prompt, served]))
        return torch.stack(rows)

    def reference_logits(self):
        ref = self.bench.module("reference", self.cell.config["reference"])
        sizes = program.reference_sizes(self.cell.config)
        W = outputs.SeededWeights(self.cell.config["init"], *self.layouts, self.seed, self.device)
        return lambda tokens, start, quant: ref.logits(sizes, W, tokens, start, quant)

    def check(self, control: bool = False) -> Dict[str, float]:
        """The compared numbers: the widest gap of the sampled requests'
        served tokens (and, with ``control``, the fp8 reference's)."""
        picks = self.sample()
        if not picks:
            return {"requests": 0}
        tokens = self.requests(picks)
        out = outputs.served_gaps(self.reference_logits(), tokens, self.P, control)
        out["requests"] = len(picks)
        return out

    # -- what the result line reports -------------------------------------------
    def counts(self) -> tuple:
        """(requests attempted in the window, requests failed)."""
        calls = self.window_record.calls
        return sum(c.rows for c in calls), sum(c.rows for c in calls if c.failed)

    def breakdown(self) -> tuple:
        """(device busy s, traced stretch s, breakdown) of the traced call."""
        tr = self.trace_record["trace"]
        lo, hi = profiling.first(tr, "perfbench.generate")
        return (tr.busy_s(lo, hi), hi - lo,
                {"device_ops": tr.top_ops(lo, hi), "idle_gaps": tr.idle_gaps(lo, hi)})
