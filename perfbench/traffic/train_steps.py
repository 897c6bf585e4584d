"""Training steps one after another through ``make_train_step``.

Parameters (the mix's file): ``batch`` rows of ``seq`` tokens a step, as
``microbatches`` slices, uniform over the vocabulary and new every step;
``optimizer``, the ``OptConfig`` (f32 moments); ``check_steps``, the first
steps that set-up drives the state through and that the reference follows;
``trace_steps``, the steps of a ``--trace 1`` run's profiled stretch.

Set-up builds one train state from the seed and drives it through its first
``check_steps`` steps (they are its warm-up too), keeping what the output
check compares: each step's loss, each leaf's norm of the first clipped
gradient (worked out from the first moment after one step: m = (1 - b1) g),
and of the masters' change over those steps.  The window's steps continue
on that same state.  The optimizer's update is marked ``perfbench.adamw``
by a wrapper of ``repro_torch.train.optimizer.update``.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

from perfbench import profiling, program, seeded


@dataclass
class Window:
    t0: float
    t1: float
    steps: List[tuple]  # (start, end, tokens)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@contextlib.contextmanager
def _marked_update():
    from repro_torch.train import optimizer

    update = optimizer.update

    def marked(*args, **kw):
        with record_function("perfbench.adamw"):
            return update(*args, **kw)

    optimizer.update = marked
    try:
        yield
    finally:
        optimizer.update = update


class Runner:
    def __init__(self, bench, cell, seed: int, device):
        self.bench, self.cell, self.seed, self.device = bench, cell, seed, torch.device(device)
        t = cell.traffic
        self.B, self.S, self.mb = t["batch"], t["seq"], t["microbatches"]
        self.cfg = program.model_config(cell.config)
        self._stack = contextlib.ExitStack()
        self.window_record: Optional[Window] = None
        self.trace_record: Optional[Dict[str, Any]] = None
        self.first: Dict[str, Any] = {}
        self.failed = 0

    def rows(self, step: int) -> torch.Tensor:
        return seeded.train_tokens(self.seed, step, self.B, self.S, self.cfg.vocab, self.device)

    def _step(self, step: int) -> float:
        """Step ``step`` (1-based) on its rows; returns its loss (which waits
        for the step)."""
        r = self.rows(step)
        self.state, metrics = self.step_fn(self.state, {"tokens": r[:, :-1], "targets": r[:, 1:]})
        loss = metrics["loss"].item()
        if not math.isfinite(loss):
            self.failed += 1
        return loss

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        from repro_torch.train import OptConfig, TrainState, make_train_step, optimizer

        t0 = time.perf_counter()
        self._stack.enter_context(_marked_update())
        model = program.build_model(self.cell.config, self.seed, self.device)
        self.shapes, self.dtypes = program.leaf_layouts(model)
        model = model.float().requires_grad_(True)  # f32 masters of bf16 draws
        self.ocfg = OptConfig(**self.cell.traffic["optimizer"])
        self.state = TrainState(params=model,
                                opt=optimizer.init(self.ocfg, dict(model.named_parameters())),
                                step=torch.zeros((), dtype=torch.int32, device=self.device))
        self.step_fn = make_train_step(self.cfg, self.ocfg, microbatches=self.mb)
        self._sync()
        t1 = time.perf_counter()
        losses = []
        for step in range(1, self.cell.traffic["check_steps"] + 1):
            losses.append(self._step(step))
            if step == 1:
                self.first["grad_norms"] = self._grad_norms()
        self.first.update(losses=losses, change_norms=self._change_norms())
        self.next_step = len(losses) + 1
        self._sync()
        self.laps = {"state": t1 - t0, "first steps": time.perf_counter() - t1}

    @torch.no_grad()
    def _grad_norms(self) -> Dict[str, float]:
        b1 = self.ocfg.b1
        return {k: m.double().norm().item() / (1 - b1) for k, m in self.state.opt.m.items()}

    @torch.no_grad()
    def _change_norms(self) -> Dict[str, float]:
        init, out = self.cell.config["init"], {}
        for name, p in self.state.params.named_parameters():
            sq = 0.0
            for i in (range(p.shape[0]) if seeded.stacked(name) else [None]):
                now = p[i] if i is not None else p
                p0 = seeded.draw_leaf(init, name, now.shape, self.dtypes[name], self.device,
                                      self.seed, i).float()
                sq += (now - p0).double().square().sum().item()
            out[name] = math.sqrt(sq)
        return out

    def window(self, seconds: float) -> Window:
        """Steps until ``seconds`` have passed, the last one whole."""
        steps = []
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            start = time.perf_counter()
            self._step(self.next_step)
            self.next_step += 1
            steps.append((start, time.perf_counter(), self.B * self.S))
        self.window_record = Window(t0=t0, t1=steps[-1][1], steps=steps)
        return self.window_record

    def trace(self, lead_s: float = 0.02) -> Dict[str, Any]:
        from torch.profiler import ProfilerActivity, profile

        n = self.cell.traffic.get("trace_steps", 2)
        self._sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead_s)
            for _ in range(n):
                with record_function("perfbench.step"):
                    self._step(self.next_step)
                self.next_step += 1
        self.trace_record = {"trace": profiling.read(prof), "steps": n}
        return self.trace_record

    def counts(self) -> tuple:
        return len(self.window_record.steps), self.failed

    def breakdown(self) -> tuple:
        tr = self.trace_record["trace"]
        spans = tr.ranges["perfbench.step"]
        lo, hi = spans[0][0], spans[-1][1]
        return (tr.busy_s(lo, hi), hi - lo,
                {"device_ops": tr.top_ops(lo, hi), "idle_gaps": tr.idle_gaps(lo, hi)})

    def release(self) -> None:
        self._stack.close()
        self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, quant: Optional[str] = None, keep: Optional[float] = None) -> Dict:
        from perfbench.reference import train

        ref = self.bench.module("reference", self.cell.config["reference"])
        n = self.cell.traffic["check_steps"]
        return train.train(ref, program.reference_sizes(self.cell.config), self.cell.config["init"],
                           self.shapes, self.dtypes, self.seed,
                           [self.rows(s) for s in range(1, n + 1)],
                           self.cell.traffic["optimizer"], self.mb, quant, keep)

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared (``reference.train.gaps``) of the program's
        first steps against the reference's; with ``control`` also the fp8
        reference's and the planted half-batch fault's against it."""
        from perfbench.reference import train
        from perfbench.reference.common import exact_f32

        with exact_f32():
            ref = self.reference()
            out = train.gaps(self.first, ref)
            if control:
                for tag, kw in (("control_", {"quant": "fp8"}), ("half_", {"keep": 0.5})):
                    out.update({tag + k: v for k, v in
                                train.gaps(self.reference(**kw), ref).items()})
        return out
