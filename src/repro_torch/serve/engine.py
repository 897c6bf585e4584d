"""Batched serving engine: prefill + incremental decode.

The port of ``repro.serve.engine``.  ``Engine`` runs a synchronous batched
loop: greedy or temperature sampling and early stop on EOS.  As in the JAX
engine, each step's sampled tokens go to the host before the next decode.

The JAX Engine jits both steps.  Here each runs as a captured CUDA graph
(``graph.CapturedStep``), one per layout of its inputs, with or without a
mesh: the prefill per layout of the batch (``tokens`` (B, S); for the
encoder-decoder also ``enc_emb``), as JAX compiles one program per prompt
shape, the last layout's kept; and the decode step
(``graph.CapturedDecode``) per layout of the decode state (batch size,
``max_len``; for the encoder-decoder also the encoder's length).  A call copies its inputs into the step's static
buffers and replays; the prefill's state is copied into the decode step's
own, and every step samples on the host side, copies the tokens in and
replays.  The first call of a layout runs eagerly on the static buffers and
is then captured.  On the CPU the same steps run uncaptured.
``cuda_graph=False`` runs both steps eagerly (the counterpart of
``jax.disable_jit``), and is the only eager route.

On a device mesh: with the model placed by ``sharding.place_module(model,
mesh, param_specs(cfg, params, sizes, "tp"))``, ``generate`` called under
``sharding.set_mesh(mesh)`` lays the batch out by ``batch_spec`` and runs
both steps on DTensors, captured as without a mesh (the layout keys hold
each tensor's mesh and placements), the decode state laid out by
``decode_state_specs``; the logits are gathered whole before sampling,
between replays, and the sampled tokens laid out by ``batch_spec`` again
and copied shard by shard into the step's token buffer.  Every rank
samples the same tokens (temperature sampling: from generators seeded
alike) and replays the same steps in the same order.  On four cards of one
host (``tools/tp_serve.py``) the captured steps, NCCL collectives inside,
give the tokens and logits of the eager steps bit for bit.

Tracing (``repro_torch.tracing``): a call is the span ``engine.generate``;
each step's sampling, from the logits to the tokens laid out for the next
step (their copy to the host included), is ``engine.sample``; the captured
steps add their own (``graph``).  Every token is copied to the host before
the next decode step is called, the last token's too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device, tracing
from ..models import EncDecLM, LM
from ..models import sharding
from .graph import CapturedDecode, CapturedStep, CudaGraph, decode_inputs, layout

Model = Union[LM, EncDecLM]


def make_prefill_step(model: Model, max_len: Optional[int] = None):
    """The prefill of a batch {"tokens"}; for the encoder-decoder, of
    {"tokens", "enc_emb"}: the encoder, then the decoder's prefill."""
    if model.cfg.family == "encdec":

        def prefill_step(batch: Dict[str, torch.Tensor]):
            memory = model.encode(batch["enc_emb"])
            return model.prefill(batch["tokens"], memory, max_len=max_len)

    else:

        def prefill_step(batch: Dict[str, torch.Tensor]):
            return model.prefill(batch["tokens"], max_len=max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(state: Dict[str, Any], tokens: torch.Tensor):
        return model.decode_step(state, tokens)

    return decode_step


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, steps)
    steps: int


class Engine:
    """Synchronous batched engine over the model's prefill and decode steps.

    ``model`` must already hold its weights on ``device`` (CUDA unless the
    caller asks for the CPU).  With ``cuda_graph`` (the default) the prefill
    and the decode step run through ``CapturedStep`` and ``CapturedDecode``:
    captured and replayed on CUDA, uncaptured on the CPU, with or without a
    mesh; a capture or replay that fails raises.  Without it both run
    eagerly.

    Memory: a captured step keeps its graph's memory pool (its outputs and
    its temporaries) while the Engine holds it.  The Engine holds one
    captured prefill, the last batch layout's (a prompt of a new length
    replaces it, and pays an eager prefill and a capture again), and one
    decode step for each layout of the decode state (batch size,
    ``max_len``; for the encoder-decoder the encoder's length), each with
    a whole decode state at ``max_len``.  On a mesh every rank holds its
    own captured steps, their NCCL collectives inside."""

    def __init__(
        self,
        model: Model,
        *,
        max_len: int = 256,
        eos_id: Optional[int] = None,
        device="cuda",
        cuda_graph: bool = True,
    ):
        self.device = resolve_device(device)
        weights_on = model.embed.device
        if weights_on.type != self.device.type:
            raise ValueError(f"model weights are on {weights_on}, engine device is {self.device}")
        self.cfg = model.cfg
        self.model = model
        self.max_len = max_len
        self.eos_id = eos_id
        self.cuda_graph = cuda_graph
        self._eager_prefill = make_prefill_step(model, max_len=max_len)
        self._eager_decode = make_decode_step(model)
        self._prefills: Dict[tuple, CapturedStep] = {}
        self._steps: Dict[tuple, CapturedDecode] = {}

    def generate(
        self,
        batch: Dict[str, torch.Tensor],
        n_steps: int,
        *,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> GenerationResult:
        """Samples ``n_steps`` tokens per row (fewer when every row hit EOS).
        Temperature sampling draws from ``generator``, which must live on
        the engine's device."""
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        B, S = batch["tokens"].shape
        with tracing.span("engine.generate", {"B": B, "prompt": S, "n_steps": n_steps}):
            batch = {k: self._laid_out(v) for k, v in batch.items()}
            logits, state = self._prefill(batch)
            outs: List[np.ndarray] = []
            done = np.zeros((B,), bool)
            for _ in range(n_steps):
                with tracing.span("engine.sample"):
                    last = sharding.whole(logits)[:, -1]
                    if temperature > 0.0:
                        probs = torch.softmax(last / temperature, dim=-1)
                        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
                    else:
                        nxt = torch.argmax(last, dim=-1)
                    nxt_np = nxt.cpu().numpy()
                    outs.append(nxt_np)
                    if self.eos_id is not None:
                        done |= nxt_np == self.eos_id
                        if done.all():
                            break
                    tokens = self._laid_out(nxt[:, None])
                logits, state = self._decode(state, tokens)
        return GenerationResult(tokens=np.stack(outs, axis=1), steps=len(outs))

    def _graph(self):
        return CudaGraph if self.device.type == "cuda" else None

    def _prefill(self, batch: Dict[str, torch.Tensor]):
        """The prefill: (last-position logits (B, 1, V), decode state), both
        the captured prefill's outputs, valid until the next prefill of the
        batch's layout; eager with ``cuda_graph`` off."""
        if not self.cuda_graph:
            return self._eager_prefill(batch)
        return self.captured_prefill(batch)(batch)

    def captured_prefill(self, batch: Dict[str, torch.Tensor]) -> CapturedStep:
        """The prefill of ``batch``'s layout, made at its first use.  It
        replaces the captured prefill of the last layout, whose graph and
        memory pool go with it: an Engine holds one captured prefill."""
        key = layout(batch)
        if key not in self._prefills:
            if self._prefills:
                tracing.count("prefill_evictions")
            self._prefills = {key: CapturedStep(self._eager_prefill, batch, self._graph())}
        return self._prefills[key]

    def _decode(self, state: Dict[str, Any], tokens: torch.Tensor):
        """One decode step: the captured step of ``state``'s layout, or the
        eager one with ``cuda_graph`` off."""
        if not self.cuda_graph:
            return self._eager_decode(state, tokens)
        return self.captured_step(state, tokens)(state, tokens)

    def captured_step(self, state: Dict[str, Any],
                      tokens: Optional[torch.Tensor] = None) -> CapturedDecode:
        """The decode step of the layout of ``state`` and ``tokens`` (by
        default (B, 1) int64), made at its first use."""
        state, tokens = decode_inputs(state, tokens)
        key = layout((state, tokens))
        if key not in self._steps:
            self._steps[key] = CapturedDecode(self._eager_decode, state, self._graph(), tokens)
        return self._steps[key]

    def _laid_out(self, t: torch.Tensor) -> torch.Tensor:
        """A batch tensor laid out by ``batch_spec`` (tp) over the current
        mesh; with no mesh, or a DTensor already, as it is."""
        mesh = sharding.current_mesh()
        if mesh is None or isinstance(t, sharding.DTensor):
            return t
        sizes = sharding.axis_sizes(mesh)
        return sharding.place(t, mesh, sharding.batch_spec(self.cfg, tuple(t.shape), sizes, "tp"))
