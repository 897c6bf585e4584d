"""Sequence-chunked softmax cross-entropy.

The port of ``repro.train.losses``.  The (B, S, V) logits are the memory
cliff of the large-vocabulary configs, so the loss runs over ``n_chunks``
sequence chunks, each ``checkpointed`` (``torch.utils.checkpoint``): only
one chunk's (B, S/c, V) logits live at a time, in the forward and again
when the backward re-forms them.  On a mesh each rank runs the chunks of
its own rows and positions, and the sums are reduced over the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..models.config import ModelConfig
from ..models.layers import kept_shards, partial_where_sharded, replicated_like, softcap
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


def _sums(cfg: ModelConfig, hidden: Tensor, w: Tensor, targets: Tensor, mask: Tensor,
          n_chunks: int):
    """The masked loss sum and correct count over ``n_chunks`` sequence
    chunks (fewer where they do not divide S), each ``checkpointed``."""
    S = hidden.shape[1]
    while S % n_chunks != 0:
        n_chunks -= 1
    C = S // n_chunks
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        cut = slice(c * C, (c + 1) * C)
        part, right = checkpointed(_chunk, cfg, hidden[:, cut], w, targets[:, cut],
                                   mask[:, cut])
        loss_sum = loss_sum + part
        correct = correct + right
    return loss_sum, correct


def _mesh_sums(cfg: ModelConfig, hidden: DTensor, w: Tensor, targets: Tensor, mask: Tensor,
               n_chunks: int):
    """``_sums`` and the mask's sum on each rank's rows of the batch and
    sequence (the unembedding gathered whole), reduced over the mesh."""
    mesh = hidden.device_mesh
    rows = kept_shards(hidden, (0, 1))
    rep = [Replicate()] * mesh.ndim
    sums = partial_where_sharded(rows)

    def local(h, t, m, wl):
        return (*_sums(cfg, h, wl, t, m, n_chunks), torch.sum(m))

    out = local_map(
        local, out_placements=(sums, sums, sums), in_placements=(rows, rows, rows, rep),
        in_grad_placements=(rows, rows, rows, sums), device_mesh=mesh,
        redistribute_inputs=True,
    )(hidden, replicated_like(targets, hidden), replicated_like(mask, hidden),
      replicated_like(w, hidden))
    return tuple(t.redistribute(mesh, rep) for t in out)


def chunked_xent(
    cfg: ModelConfig,
    model: nn.Module,  # its ``unembed``, else the tied ``embed``
    hidden: Tensor,  # (B, S, D)
    targets: Tensor,  # (B, S)
    mask: Optional[Tensor] = None,  # (B, S)
    n_chunks: Optional[int] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean next-token loss over the unmasked positions, and the metrics
    ``accuracy`` and ``tokens`` (the mask's sum), as the reference.  On a
    mesh (a DTensor ``hidden``) each rank sums its own positions."""
    B, S, D = hidden.shape
    n_chunks = n_chunks or cfg.loss_seq_chunks
    w = getattr(model, "unembed", None)
    if w is None:
        w = model.embed.T  # (D, V)
    w = w.to(hidden.dtype)  # once, not once per chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if isinstance(hidden, DTensor):
        loss_sum, correct, total = _mesh_sums(cfg, hidden, w, targets, mask, n_chunks)
    else:
        loss_sum, correct = _sums(cfg, hidden, w, targets, mask, n_chunks)
        total = torch.sum(mask)
    denom = torch.clamp(total, min=1.0)
    return loss_sum / denom, {"accuracy": correct / denom, "tokens": denom}
