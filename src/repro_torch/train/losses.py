"""Sequence-chunked softmax cross-entropy.

The port of ``repro.train.losses``.  The (B, S, V) logits are the memory
cliff of the large-vocabulary configs, so the loss runs over ``n_chunks``
sequence chunks, each ``checkpointed`` (``torch.utils.checkpoint``): only
one chunk's (B, S/c, V) logits live at a time, in the forward and again
when the backward re-forms them.  On a mesh each rank runs the chunks of
its own rows and positions, and the sums are reduced over the mesh.  Where
the tp specs split the unembedding's vocabulary over 'model', each rank
forms its shard's logits for every position of its rows (the positions
gathered over 'model', not the table), and the log-sum-exp, the target's
logit and the argmax are reduced over 'model' (``_chunk_shard``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..models.config import ModelConfig
from ..models.layers import (kept_shards, model_dim, on_mesh, partial_where_sharded,
                             replicated_like, softcap, tp_dim)
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


def _chunk_shard(cfg: ModelConfig, h: Tensor, w: Tensor, t: Tensor, m: Tensor, *, v0: int,
                 group):
    """``_chunk`` on this rank's vocabulary shard ``w`` (D, V/M; its first
    entry is v0) among the ranks of ``group``: the max over the whole
    vocabulary, the sum of exponentials and the target's logit reduced over
    the group, the argmax the least index among the ranks' maxima that
    equal the largest.  The reduced terms carry no gradient across ranks:
    each rank's loss differentiates its own logits only (softmax less the
    target's one-hot), so a loss that every rank holds alike is not
    counted M times."""
    logits = softcap(torch.matmul(h, w).float(), cfg.final_logit_softcap)
    V = logits.shape[-1]
    top, at = logits.detach().max(dim=-1)
    mx = funcol.all_reduce(top, "max", group)
    s = torch.exp(logits - mx[..., None]).sum(dim=-1)
    total = funcol.all_reduce(s.detach(), "sum", group)
    lse = mx + torch.log(total) + (s - s.detach()) / total
    mine = (t >= v0) & (t < v0 + V)
    picked = logits.gather(-1, (t - v0).clamp(0, V - 1)[..., None].long())[..., 0]
    local = torch.where(mine, picked, torch.zeros_like(picked))
    ll = funcol.all_reduce(local.detach(), "sum", group) + (local - local.detach())
    loss_sum = torch.sum((lse - ll) * m)
    first = funcol.all_reduce(torch.where(top == mx, (at + v0).float(), torch.inf), "min", group)
    correct = torch.sum((first == t) * m)
    return loss_sum, correct


def _sums(cfg: ModelConfig, hidden: Tensor, w: Tensor, targets: Tensor, mask: Tensor,
          n_chunks: int, chunk=_chunk):
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
        part, right = checkpointed(chunk, cfg, hidden[:, cut], w, targets[:, cut],
                                   mask[:, cut])
        loss_sum = loss_sum + part
        correct = correct + right
    return loss_sum, correct


def _mesh_sums(cfg: ModelConfig, hidden: DTensor, w: Tensor, targets: Tensor, mask: Tensor,
               n_chunks: int):
    """``_sums`` and the mask's sum on each rank's rows of the batch and
    sequence, reduced over the mesh: on the unembedding's vocabulary shard
    where the tp specs split it over 'model' (``_chunk_shard``, the
    positions gathered over 'model'), else with it gathered whole."""
    mesh = hidden.device_mesh
    rows = kept_shards(hidden, (0, 1))
    rep = [Replicate()] * mesh.ndim
    w = replicated_like(w, hidden)
    mi = model_dim(mesh)
    chunk, w_p, h_grad = _chunk, rep, rows
    if tp_dim(w) == 1 and mesh.size(mi) > 1:
        rows[mi] = Replicate()
        chunk = functools.partial(_chunk_shard, v0=mesh.get_local_rank(mi) * (w.shape[1]
                                                                              // mesh.size(mi)),
                                  group=(mesh, mi))
        w_p, h_grad = on_mesh(mesh, model=Shard(1)), on_mesh(mesh, rows, model=Partial())
    sums = partial_where_sharded(rows)
    w_grad = [wp if isinstance(wp, Shard) else sp for wp, sp in zip(w_p, sums)]

    def local(h, t, m, wl):
        return (*_sums(cfg, h, wl, t, m, n_chunks, chunk), torch.sum(m))

    out = local_map(
        local, out_placements=(sums, sums, sums), in_placements=(rows, rows, rows, w_p),
        in_grad_placements=(h_grad, rows, rows, w_grad), device_mesh=mesh,
        redistribute_inputs=True,
    )(hidden, replicated_like(targets, hidden), replicated_like(mask, hidden), w)
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
