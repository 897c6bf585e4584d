"""The Engine's two steps captured as CUDA graphs: the port's ``jax.jit`` of them.

The JAX Engine jits its prefill and its decode step, so each runs as one
compiled program per shape of its inputs.  ``CapturedStep`` is the
counterpart: a step on static buffers, captured once for each layout of its
inputs (every tensor's shape, type and device; for a DTensor also its mesh
and placements) and replayed.  The prefill is one, over a batch layout
(``tokens`` (B, S), and for the encoder-decoder ``enc_emb``);
``CapturedDecode`` is the decode step, over a layout of the decode state
(the batch, ``max_len`` and, for the encoder-decoder, the encoder's
length).

* Static buffers: zeros laid out as the first inputs (a DTensor's on its
  mesh, with its placements).  A call copies its inputs into them in place,
  shard by shard (each rank its local tensor: nothing is redistributed),
  and skips a tensor that is already the buffer.  The decode step's buffers
  are a decode state and a (B, 1) token buffer; it copies its ``pos + 1``
  back into the state's ``pos`` (the model returns it out of place), so
  every tensor it reads and writes stays where the capture saw it.
* The first call of a layout runs uncaptured on a side stream, on the
  static buffers: it is a real step, and it fills the lazy caches that a
  capture could not (the kernel library, ``flash_decode``'s split plan,
  RoPE's frequencies, cuBLAS's workspace for that stream; on a mesh
  DTensor's sharding propagation and the NCCL communicator).  The capture
  follows on the same stream; it launches nothing, and replays run every
  later call.
* Outputs: what the captured step returns, which lives in the graph's
  memory pool, valid until the next call of that layout.  The prefill's
  decode state (its caches allocated and zeroed inside the graph, so each
  replay zeroes them past the prompt again) is copied by the decode step
  into its own buffers, so a prefill's outputs are never written by a
  decode step.
* On a mesh: every collective of the step (the row-parallel projections'
  reductions over 'model', the weights' gathers over 'data', Mamba-2's
  all-to-alls, ``decode_merge``'s all-reduces) is waited on inside it, so
  the capture joins NCCL's stream; every rank captures and replays the
  same steps in the same order, so the captured collectives stay matched.
  Gathering the logits whole
  (``sharding.whole``) runs between replays, in ``Engine.generate``.
* Launch counts: ``ops.LAUNCHES`` / ``LAUNCH_SHAPES`` count the wrappers'
  Python calls.  A capture leaves them as they were, and every replay adds
  the counts that the capture's Python made: one step's launches.
* Without ``graph`` (the CPU) the same step runs uncaptured every time, on
  the same buffers, so the CPU runs exactly the step that the card captures.
* Tracing (``repro_torch.tracing``): a layout's first call is the span
  ``step.capture`` and counts in ``captures.<kind>`` and
  ``capture_s.<kind>``; every later call is the span ``step.replay``, whose
  events sit on the current stream just before and after the replay, and
  counts in ``replays.<kind>`` (``kind`` ``prefill`` or ``decode``).  No
  event is recorded inside a capture.

A capture or a replay that fails raises; nothing falls back to the eager
step.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from .. import tracing
from ..kernels import ops

Step = Callable[[Dict[str, Any], torch.Tensor], Tuple[torch.Tensor, Dict[str, Any]]]


def _leaf_layout(t: torch.Tensor) -> tuple:
    key = (tuple(t.shape), t.dtype, t.device)
    if isinstance(t, DTensor):
        key += (t.device_mesh, tuple(t.placements))
    return key


def layout(tree: Any) -> tuple:
    """The key of a tree of tensors' layout: its structure and every
    tensor's shape, type and device; a DTensor's mesh and placements too,
    so that two trees laid out otherwise never share a captured step."""
    leaves, spec = tree_flatten(tree)
    return (repr(spec), tuple(_leaf_layout(t) for t in leaves))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def static_like(t: torch.Tensor) -> torch.Tensor:
    """Zeros laid out as ``t``: a DTensor's on its mesh with its placements,
    global shape and stride, each rank allocating its own shard."""
    if not isinstance(t, DTensor):
        return torch.zeros_like(t)
    return DTensor.from_local(torch.zeros_like(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


class CudaGraph:
    """A CUDA graph and the side stream that it is warmed up and captured on."""

    def __init__(self):
        self.stream = torch.cuda.Stream()
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def warm_up(self, body: Callable[[], Any]) -> Any:
        """Runs ``body`` on the side stream, after the work queued so far."""
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = body()
        current.wait_stream(self.stream)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                _local(t).record_stream(current)
        return out

    def capture(self, body: Callable[[], Any]) -> Any:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            return body()

    def replay(self) -> None:
        self.graph.replay()


class CapturedStep:
    """``fn(inputs)`` on static buffers, for the layout of ``like``: on CUDA
    captured (``graph``, e.g. ``CudaGraph``, makes the graph) and replayed;
    without ``graph`` run uncaptured.  ``kind`` names the step in spans and
    counters: the Engine's prefill."""

    kind = "prefill"

    def __init__(self, fn: Callable[[Any], Any], like: Any,
                 graph: Optional[Callable[[], Any]] = None):
        self.fn = fn
        self.key = layout(like)
        self.inputs = tree_map(static_like, like)
        self.graph = graph() if graph is not None else None
        self.span_attrs = {"kind": self.kind}  # built once: a call builds nothing to trace
        self.replays_key = "replays." + self.kind
        self.made = False  # its first call ran (and, with a graph, captured it)
        self.captured = False
        self.out: Any = None  # the captured step's outputs
        self.launches: Counter = Counter()  # the capture's counts: one step's
        self.launch_shapes: Counter = Counter()
        self.replays = 0

    def body(self) -> Any:
        return self.fn(self.inputs)

    def load(self, inputs: Any) -> None:
        """Copies ``inputs`` (of this step's layout) into the static buffers,
        each rank its local shard; a tensor that is its own buffer stays as
        it is.  Raises unless ``inputs`` are laid out as the step's."""
        if layout(inputs) != self.key:
            raise ValueError("the inputs' layout is not the captured step's")
        for dst, src in zip(tree_leaves(self.inputs), tree_leaves(inputs)):
            if dst is not src:
                _local(dst).copy_(_local(src))

    def __call__(self, inputs: Any) -> Any:
        """The step on ``inputs``, copied into the static buffers."""
        self.load(inputs)
        return self.run()

    def run(self) -> Any:
        """The step on the static buffers as they stand: the first call
        uncaptured, then the capture; later calls one replay each."""
        if not self.made:
            return self._first()
        with tracing.span("step.replay", self.span_attrs):
            out = self.body() if self.graph is None else self._replay()
        tracing.count(self.replays_key)
        return out

    def _first(self) -> Any:
        """The layout's first call: the step uncaptured and, with a graph, its
        capture."""
        start = time.perf_counter()
        with tracing.span("step.capture", self.span_attrs):
            if self.graph is None:
                out = self.body()
            else:
                out = self.graph.warm_up(self.body)
                self._capture()
        self.made = True
        tracing.count("captures." + self.kind)
        tracing.count("capture_s." + self.kind, time.perf_counter() - start)
        return out

    def _replay(self) -> Any:
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        ops.LAUNCH_SHAPES.update(self.launch_shapes)
        return self.out

    def _capture(self) -> None:
        launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)
        try:
            self.out = self.graph.capture(self.body)
            self.launches = Counter({k: ops.LAUNCHES[k] - n for k, n in launches.items()})
            self.launch_shapes = ops.LAUNCH_SHAPES - shapes
            self.captured = True
        finally:
            ops.LAUNCHES.update(launches)
            ops.LAUNCH_SHAPES.clear()
            ops.LAUNCH_SHAPES.update(shapes)


def decode_inputs(state: Dict[str, Any],
                  tokens: Optional[torch.Tensor] = None) -> Tuple[Dict[str, Any], torch.Tensor]:
    """A decode step's inputs, ``(state, tokens)``; ``tokens`` by default
    (B, 1) int64 zeros on ``pos``'s device."""
    if tokens is None:
        pos = state["pos"]
        tokens = torch.zeros((pos.shape[0], 1), dtype=torch.long, device=pos.device)
    return state, tokens


class CapturedDecode(CapturedStep):
    """One decode step, ``step(state, tokens)``, on static buffers for the
    layout of its inputs ``decode_inputs(like, tokens)``: the decode state
    and the (B, 1) tokens (the Engine gives its first tokens, on a mesh laid
    out by ``batch_spec``)."""

    kind = "decode"

    def __init__(self, step: Step, like: Dict[str, Any],
                 graph: Optional[Callable[[], Any]] = None,
                 tokens: Optional[torch.Tensor] = None):
        super().__init__(step, decode_inputs(like, tokens), graph)
        self.state, self.tokens = self.inputs

    def body(self) -> torch.Tensor:
        logits, new = self.fn(self.state, self.tokens)
        _local(self.state["pos"]).copy_(_local(new["pos"]))
        return logits

    def __call__(self, state: Dict[str, Any], tokens: torch.Tensor):
        """One step from ``state`` (this step's own after the first call,
        else copied in) and ``tokens`` (B, 1): (logits (B, 1, V), the
        static state)."""
        self.load((state, tokens))
        return self.run(), self.state
