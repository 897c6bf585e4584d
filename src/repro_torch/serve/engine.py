"""Batched serving engine: prefill + incremental decode.

The port of ``repro.serve.engine``.  ``Engine`` runs a synchronous batched
loop: greedy or temperature sampling and early stop on EOS.  As in the JAX
engine, each step's sampled tokens go to the host before the next decode.

The JAX Engine jits both steps.  Here the decode step runs as one captured
CUDA graph (``graph.CapturedDecode``), one per layout of the decode state
(batch size; for the encoder-decoder also the encoder's length): the
prefill runs eagerly, its state is copied into the captured step's own, and
every step samples on the host side, copies the tokens in and replays.  The
first step of a layout runs eagerly on the static buffers and is then
captured.  On the CPU the same step runs uncaptured.  ``cuda_graph=False``
runs the eager step (the counterpart of ``jax.disable_jit``).  The prefill
stays eager: its shapes vary with the prompt.

On a device mesh: with the model placed by ``sharding.place_module(model,
mesh, param_specs(cfg, params, sizes, "tp"))``, ``generate`` called under
``sharding.set_mesh(mesh)`` lays the batch out by ``batch_spec`` and runs
both steps on DTensors, the decode state laid out by
``decode_state_specs``; the logits are gathered whole before sampling, and
the sampled tokens laid out by ``batch_spec`` again.  Every rank samples
the same tokens (temperature sampling: from generators seeded alike).  The
decode step on a mesh runs eagerly: no graph is captured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..models import EncDecLM, LM
from ..models import sharding
from .graph import CapturedDecode, CudaGraph, layout

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
    caller asks for the CPU).  With ``cuda_graph`` (the default) the decode
    step runs through ``CapturedDecode``: captured and replayed on CUDA,
    uncaptured on the CPU; a capture or replay that fails raises.  Without
    it, and on a mesh, the decode step runs eagerly."""

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
        self._prefill = make_prefill_step(model, max_len=max_len)
        self._eager_decode = make_decode_step(model)
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
        batch = {k: self._laid_out(v) for k, v in batch.items()}
        logits, state = self._prefill(batch)
        B = batch["tokens"].shape[0]
        outs: List[np.ndarray] = []
        done = np.zeros((B,), bool)
        for _ in range(n_steps):
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
            logits, state = self._decode(state, self._laid_out(nxt[:, None]))
        return GenerationResult(tokens=np.stack(outs, axis=1), steps=len(outs))

    def _decode(self, state: Dict[str, Any], tokens: torch.Tensor):
        """One decode step: the captured step of ``state``'s layout, or the
        eager one (``cuda_graph`` off, or a mesh)."""
        if not self.cuda_graph or sharding.current_mesh() is not None:
            return self._eager_decode(state, tokens)
        return self.captured_step(state)(state, tokens)

    def captured_step(self, state: Dict[str, Any]) -> CapturedDecode:
        """The decode step of ``state``'s layout, made at its first use."""
        key = layout(state)
        if key not in self._steps:
            graph = CudaGraph if self.device.type == "cuda" else None
            self._steps[key] = CapturedDecode(self._eager_decode, state, graph)
        return self._steps[key]

    def _laid_out(self, t: torch.Tensor) -> torch.Tensor:
        """A batch tensor laid out by ``batch_spec`` (tp) over the current
        mesh; with no mesh, or a DTensor already, as it is."""
        mesh = sharding.current_mesh()
        if mesh is None or isinstance(t, sharding.DTensor):
            return t
        sizes = sharding.axis_sizes(mesh)
        return sharding.place(t, mesh, sharding.batch_spec(self.cfg, tuple(t.shape), sizes, "tp"))
