"""Sequence-chunked softmax cross-entropy.

The port of ``repro.train.losses``.  The (B, S, V) logits are the memory
cliff of the large-vocabulary configs, so the loss runs over ``n_chunks``
sequence chunks, each ``checkpointed`` (``torch.utils.checkpoint``): only
one chunk's (B, S/c, V) logits live at a time, in the forward and again
when the backward re-forms them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.config import ModelConfig
from ..models.layers import softcap
from ..models.lm import checkpointed

Tensor = torch.Tensor


def _chunk(cfg: ModelConfig, h: Tensor, w: Tensor, t: Tensor, m: Tensor):
    """One chunk's masked loss sum and correct count: logits in the hidden
    type, then f32 and the final softcap, as the reference."""
    logits = softcap(torch.matmul(h, w).float(), cfg.final_logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, t[..., None].long())[..., 0]
    loss_sum = torch.sum((lse - ll) * m)
    correct = torch.sum((torch.argmax(logits, dim=-1) == t) * m)
    return loss_sum, correct


def chunked_xent(
    cfg: ModelConfig,
    model: nn.Module,  # its ``unembed``, else the tied ``embed``
    hidden: Tensor,  # (B, S, D)
    targets: Tensor,  # (B, S)
    mask: Optional[Tensor] = None,  # (B, S)
    n_chunks: Optional[int] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean next-token loss over the unmasked positions, and the metrics
    ``accuracy`` and ``tokens`` (the mask's sum), as the reference."""
    B, S, D = hidden.shape
    n_chunks = n_chunks or cfg.loss_seq_chunks
    while S % n_chunks != 0:
        n_chunks -= 1
    C = S // n_chunks
    w = getattr(model, "unembed", None)
    if w is None:
        w = model.embed.T  # (D, V)
    w = w.to(hidden.dtype)  # once, not once per chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        cut = slice(c * C, (c + 1) * C)
        part, right = checkpointed(_chunk, cfg, hidden[:, cut], w, targets[:, cut],
                                   mask[:, cut])
        loss_sum = loss_sum + part
        correct = correct + right
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return loss_sum / denom, {"accuracy": correct / denom, "tokens": denom}
