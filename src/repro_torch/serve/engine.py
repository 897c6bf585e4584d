"""Batched serving engine: prefill + incremental decode.

The port of ``repro.serve.engine``.  ``Engine`` runs a synchronous batched
loop: greedy or temperature sampling and early stop on EOS.  As in the JAX
engine, each step's sampled tokens go to the host before the next decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..models import EncDecLM, LM

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
    caller asks for the CPU)."""

    def __init__(
        self,
        model: Model,
        *,
        max_len: int = 256,
        eos_id: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        weights_on = model.embed.device
        if weights_on.type != self.device.type:
            raise ValueError(f"model weights are on {weights_on}, engine device is {self.device}")
        self.cfg = model.cfg
        self.model = model
        self.max_len = max_len
        self.eos_id = eos_id
        self._prefill = make_prefill_step(model, max_len=max_len)
        self._decode = make_decode_step(model)

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
        logits, state = self._prefill(batch)
        B = batch["tokens"].shape[0]
        outs: List[np.ndarray] = []
        done = np.zeros((B,), bool)
        for _ in range(n_steps):
            last = logits[:, -1]
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
            logits, state = self._decode(state, nxt[:, None])
        return GenerationResult(tokens=np.stack(outs, axis=1), steps=len(outs))
