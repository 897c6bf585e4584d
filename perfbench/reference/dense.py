"""Plain f32 forward of a dense decoder as the port runs stablelm-2-12b.

Embedding rows; per layer RMSNorm (x / rms * (1 + w)), q, k, v
projections, rotary embeddings on the first and second halves of each
head, causal grouped-query attention (softmax of q k / sqrt(hd)), the
output projection and the residual; RMSNorm, the gated MLP
(silu(x w_gate) * (x w_in)) w_out and the residual; a final RMSNorm and
the unembedding.  Leaves are named as the port names its parameters, so
the same seeded draws feed both.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.common import Tensor, Weights, mm, rms_norm, silu

Q_BLOCK = 512  # query rows a block of attention: (rows, H, Q_BLOCK, T) f32 scores


def _rope(x: Tensor, theta: float) -> Tensor:
    """x (R, T, H, hd) at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freq
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal attention of q (R, T, H, hd) over k, v (R, T, K, hd), in
    blocks of queries."""
    R, T, H, hd = q.shape
    K = k.shape[2]
    kk = k.repeat_interleave(H // K, dim=2).transpose(1, 2)  # (R, H, T, hd)
    vv = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
    qq = q.transpose(1, 2) * hd ** -0.5
    outs = []
    for s in range(0, T, Q_BLOCK):
        e = min(s + Q_BLOCK, T)
        scores = qq[:, :, s:e] @ kk[:, :, :e].transpose(-1, -2)  # (R, H, e-s, e)
        keys, rows = torch.arange(e, device=q.device), torch.arange(s, e, device=q.device)
        mask = keys[None, :] > rows[:, None]
        scores = scores.masked_fill(mask, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ vv[:, :, :e])
    return torch.cat(outs, dim=2).transpose(1, 2)  # (R, T, H, hd)


def layer(m: Dict, W: Weights, i: int, x: Tensor, quant: Optional[str] = None) -> Tensor:
    D, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    R, T, _ = x.shape
    eps = m["norm_eps"]
    h = rms_norm(x, W("blocks.ln1", i), eps)
    q = mm(h, W("blocks.attn.wq", i).reshape(D, H * hd), quant).reshape(R, T, H, hd)
    k = mm(h, W("blocks.attn.wk", i).reshape(D, K * hd), quant).reshape(R, T, K, hd)
    v = mm(h, W("blocks.attn.wv", i).reshape(D, K * hd), quant).reshape(R, T, K, hd)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    o = _attention(q, k, v).reshape(R, T, H * hd)
    x = x + mm(o, W("blocks.attn.wo", i).reshape(H * hd, D), quant)
    h = rms_norm(x, W("blocks.ln2", i), eps)
    g = silu(mm(h, W("blocks.mlp.w_gate", i), quant)) * mm(h, W("blocks.mlp.w_in", i), quant)
    return x + mm(g, W("blocks.mlp.w_out", i), quant)


def unembedding(m: Dict, W: Weights) -> Tensor:
    return W("embed", None).T if m["tie_embeddings"] else W("unembed", None)


def logits(m: Dict, W: Weights, tokens: Tensor, start: int, quant: Optional[str] = None) -> Tensor:
    """The f32 logits (R, T - start, V) at positions start..T-1 of
    ``tokens`` (R, T)."""
    x = W("embed", None)[tokens]
    for i in range(m["n_layers"]):
        x = layer(m, W, i, x, quant)
    x = rms_norm(x[:, start:], W("final_norm", None), m["norm_eps"])
    return mm(x, unembedding(m, W), quant)
