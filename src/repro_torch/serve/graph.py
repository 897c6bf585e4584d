"""The decode step captured as a CUDA graph: the port's ``jax.jit`` of it.

The JAX Engine jits its decode step, so each step after the first runs as
one compiled program.  ``CapturedDecode`` is the counterpart for one layout
of the decode state (the shape of every tensor in it: the batch, ``max_len``
and, for the encoder-decoder, the encoder's length): the step from the
sampled tokens to the logits on buffers of its own, captured once and
replayed.

* Static buffers: a decode state (zeros laid out as the first state it is
  given), a (B, 1) token buffer, and the logits that the captured step
  writes.  A step given a state other than its own first copies that state
  into its own, every tensor in place (the caches, ``pos``, the SSM state
  and conv window, the hybrid's shared-block caches, the encoder-decoder's
  cross-attention K/V).
* The step runs ``decode_step(state, tokens)`` and copies its ``pos + 1``
  back into the state's ``pos`` (the model returns it out of place), so
  every tensor it reads and writes stays where the capture saw it.
* The first step of a layout runs uncaptured on a side stream, on the
  static buffers: it is a real step, and it fills the lazy caches (the
  kernel library, ``flash_decode``'s split plan, cuBLAS's workspace for
  that stream) that a capture could not.  The capture follows on the same
  stream; it launches nothing, and replays run every later step.
* Launch counts: ``ops.LAUNCHES`` / ``LAUNCH_SHAPES`` count the wrappers'
  Python calls.  A capture leaves them as they were, and every replay adds
  the counts that the capture's Python made: one step's launches.
* Without ``graph`` (the CPU) the same step runs uncaptured every time, so
  the CPU runs exactly the step that the card captures.

A capture or a replay that fails raises; nothing falls back to the eager
step.  The logits and state a step returns are the static buffers: valid
until the next step.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from ..kernels import ops

Step = Callable[[Dict[str, Any], torch.Tensor], Tuple[torch.Tensor, Dict[str, Any]]]


def layout(state: Dict[str, Any]) -> tuple:
    """The key of a decode state's layout: its tree and every tensor's
    shape, type and device."""
    leaves, spec = tree_flatten(state)
    return (repr(spec), tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))


class CudaGraph:
    """A CUDA graph and the side stream that it is warmed up and captured on."""

    def __init__(self):
        self.stream = torch.cuda.Stream()
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def warm_up(self, body: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Runs ``body`` on the side stream, after the work queued so far."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = body()
        current.wait_stream(self.stream)
        out.record_stream(current)
        return out

    def capture(self, body: Callable[[], torch.Tensor]) -> torch.Tensor:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            return body()

    def replay(self) -> None:
        self.graph.replay()


class CapturedDecode:
    """One decode step on static buffers, for the layout of ``like``: on
    CUDA captured (``graph``, e.g. ``CudaGraph``, makes the graph) and
    replayed; without ``graph`` run uncaptured."""

    def __init__(self, step: Step, like: Dict[str, Any],
                 graph: Optional[Callable[[], Any]] = None):
        self.step = step
        self.key = layout(like)
        self.state = tree_map(torch.zeros_like, like)
        pos = self.state["pos"]
        self.tokens = torch.zeros((pos.shape[0], 1), dtype=torch.long, device=pos.device)
        self.graph = graph() if graph is not None else None
        self.captured = False
        self.logits: Optional[torch.Tensor] = None  # the captured step's output
        self.launches: Counter = Counter()  # the capture's counts: one step's
        self.launch_shapes: Counter = Counter()
        self.replays = 0

    def body(self) -> torch.Tensor:
        logits, new = self.step(self.state, self.tokens)
        self.state["pos"].copy_(new["pos"])
        return logits

    def load(self, state: Dict[str, Any]) -> None:
        """Copies ``state`` (of this step's layout) into the static state."""
        if layout(state) != self.key:
            raise ValueError("the decode state's layout is not the captured step's")
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            dst.copy_(src)

    def __call__(self, state: Dict[str, Any], tokens: torch.Tensor):
        """One step from ``state`` (this step's own after the first call,
        else copied in) and ``tokens`` (B, 1): (logits (B, 1, V), the
        static state)."""
        if state is not self.state:
            self.load(state)
        self.tokens.copy_(tokens)
        if self.graph is None:
            return self.body(), self.state
        if not self.captured:
            first = self.graph.warm_up(self.body)
            self._capture()
            return first, self.state
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        ops.LAUNCH_SHAPES.update(self.launch_shapes)
        return self.logits, self.state

    def _capture(self) -> None:
        launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)
        try:
            self.logits = self.graph.capture(self.body)
            self.launches = Counter({k: ops.LAUNCHES[k] - n for k, n in launches.items()})
            self.launch_shapes = ops.LAUNCH_SHAPES - shapes
            self.captured = True
        finally:
            ops.LAUNCHES.update(launches)
            ops.LAUNCH_SHAPES.clear()
            ops.LAUNCH_SHAPES.update(shapes)
