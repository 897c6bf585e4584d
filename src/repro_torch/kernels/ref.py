"""Plain PyTorch versions of the kernels (the allclose targets).

These restate each kernel's math with materialized intermediates (no
blocking, no online softmax) in the TPU kernels' layouts: (B, heads, S, hd)
for attention, with the same finite ``MASK``, and (B, nh, nC, Q, ...) for
the SSD intra-chunk block, all in f32.  Rows with no valid key are outside
the attention kernels' contract over a whole cache: here, as in the JAX
reference, such a row gets the mean of V.  On a shard of a cache split
along its sequence (``key_offset``), or with ``return_lse``, such a row is
in the contract and gets output 0 and log-sum-exp -inf: its weight in the
merge of the shards' partials is exactly 0.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

MASK = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, K, Sk, hd)
    v: torch.Tensor,  # (B, K, Sk, hd)
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    rep = H // K
    qg = q.reshape(B, K, rep, Sq, hd).float()
    s = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, MASK)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bksd->bkrqd", w, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, hd)
    k_cache: torch.Tensor,  # (B, K, S, hd)
    v_cache: torch.Tensor,  # (B, K, S, hd)
    lengths: torch.Tensor,  # (B,) in global positions
    *,
    scale: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    key_offset: Union[int, torch.Tensor, None] = None,  # scalar or (B,)
    return_lse: bool = False,
):
    """The new token's attention over the keys [lengths - window, lengths)
    (global positions) that the cache holds; a shard of a cache split along
    its sequence holds keys [key_offset, key_offset + S).  With
    ``return_lse`` also the f32 (B, H) log-sum-exp of the scaled, softcapped
    logits over those keys."""
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    qg = q.reshape(B, K, rep, hd).float()
    s = torch.einsum("bkrd,bksd->bkrs", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kp = torch.arange(S, device=q.device)[None, :]
    if key_offset is not None:
        kp = kp + torch.as_tensor(key_offset, device=q.device).reshape(-1, 1)
    ok = kp < lengths[:, None]
    if window is not None:
        ok &= kp >= (lengths[:, None] - window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, MASK)
    w = torch.softmax(s, dim=-1)
    if key_offset is not None or return_lse:
        w = torch.where(ok, w, 0.0)  # a row with no valid key: all weights 0
    o = torch.einsum("bkrs,bksd->bkrd", w, v_cache.float())
    o = o.reshape(B, H, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1)
    return o, lse.reshape(B, H)


def ssd_intra_chunk_ref(
    x: torch.Tensor,  # (B, nh, nC, Q, hd)
    a: torch.Tensor,  # (B, nh, nC, Q) log decays
    Bm: torch.Tensor,  # (B, nh, nC, Q, N)
    Cm: torch.Tensor,  # (B, nh, nC, Q, N)
):
    """Returns (y_diag (B,nh,nC,Q,hd), states (B,nh,nC,N,hd), cum (B,nh,nC,Q)),
    all f32."""
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    Q = x.shape[3]
    cum = torch.cumsum(a.float(), dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(Q, device=x.device)
    L = torch.where(i[:, None] >= i[None, :], torch.exp(diff), 0.0)
    scores = torch.einsum("bhcqn,bhcsn->bhcqs", C32, B32)
    y = torch.einsum("bhcqs,bhcsp->bhcqp", scores * L, x32)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bhcqn,bhcq,bhcqp->bhcnp", B32, decay_to_end, x32)
    return y, states, cum
