"""The kernels in the model's layouts: the API the model layers call.

For a CUDA tensor each op launches its hand-written kernel, or raises; there
is no fallback.  For a CPU tensor it runs the plain version in ``ref``.
Unlike the JAX wrappers, which transpose q, k and v (and the whole cache on
every decode) into the kernels' layout, and copy the SSD's B and C out to
every head, the kernels here read the model's layout through strides.

``LAUNCHES`` counts the kernel launches of each op, so a run can show that
its path went through the kernels; ``LAUNCH_SHAPES`` counts them by call
shape, so a path that runs a kernel at several shapes (an encoder, a
decoder, its cross-attention; a windowed layer beside a global one) shows
how often it ran each.

The kernels have no backward (nor have the reference's Pallas kernels): on
a CUDA tensor each op raises while autograd records, naming the plain path
to take instead.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import ref
from .decode_attention import flash_decode
from .flash_attention import flash_prefill
from .ssd_scan import ssd_intra_chunk as _ssd_kernel

LAUNCHES: Dict[str, int] = {"flash_prefill": 0, "flash_decode": 0, "ssd_intra_chunk": 0}
# (kernel, shape) -> launches; the shapes: flash_prefill (B, Sq, Sk, H, K, hd,
# causal, window, softcap), flash_decode (B, S, H, K, hd, window, softcap),
# ssd_intra_chunk (B, S, nh, hd, N); window and softcap are None when off,
# so a model's windowed (local) and global layers count apart.
LAUNCH_SHAPES: Counter = Counter()


def prefill_shape(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
                  softcap: Optional[float]) -> tuple:
    """``flash_prefill``'s shape key in ``LAUNCH_SHAPES`` for q (B, Sq, H, hd)
    and k (B, Sk, K, hd)."""
    B, Sq, H, hd = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], hd, causal, window, softcap)


def decode_shape(q: torch.Tensor, k_cache: torch.Tensor, window: Optional[int],
                 softcap: Optional[float]) -> tuple:
    """``flash_decode``'s shape key in ``LAUNCH_SHAPES`` for q (B, 1, H, hd)
    and a cache (B, S, K, hd)."""
    B, _, H, hd = q.shape
    return (B, k_cache.shape[1], H, k_cache.shape[2], hd, window, softcap)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _refuse_autograd(op: str, plain: str, *tensors: Optional[torch.Tensor]) -> None:
    if records_grad(*tensors):
        raise RuntimeError(f"{op}: the CUDA kernel has no backward; under autograd take "
                           f"the plain path ({plain})")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, K, hd)
    v: torch.Tensor,  # (B, Sk, K, hd)
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Prefill attention; returns (B, Sq, H, hd) in q's type."""
    if not q.is_cuda:
        out = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=causal, window=window, softcap=softcap,
        )
        return out.transpose(1, 2)
    _refuse_autograd("flash_attention", "models.layers.attention_naive or attention_chunked",
                     q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_prefill(q, k, v, out, scale=scale, causal=causal, window=window, softcap=softcap)
    LAUNCHES["flash_prefill"] += 1
    LAUNCH_SHAPES["flash_prefill", prefill_shape(q, k, causal, window, softcap)] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, K, hd)
    v_cache: torch.Tensor,  # (B, S, K, hd)
    lengths: torch.Tensor,  # (B,) valid entries per row, in global positions
    *,
    scale: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    key_offset: Union[int, torch.Tensor, None] = None,
    return_lse: bool = False,
):
    """One-token attention over the cache; returns (B, 1, H, hd).  On a
    shard of a cache split along its sequence, ``key_offset`` (an int or a
    (B,) tensor) is the global position of its first key; with
    ``return_lse`` also the f32 (B, H) log-sum-exp over the keys read
    (``merge_decode_partials`` merges shards)."""
    if not q.is_cuda:
        out = ref.decode_attention_ref(
            q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), lengths,
            scale=scale, window=window, softcap=softcap, key_offset=key_offset,
            return_lse=return_lse,
        )
        return (out[0][:, None], out[1]) if return_lse else out[:, None]
    _refuse_autograd("decode_attention", "models.layers.attention_decode", q, k_cache, v_cache)
    B, _, H, hd = q.shape
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, dtype=torch.float32, device=q.device) if return_lse else None
    if isinstance(key_offset, torch.Tensor):
        key_offset = key_offset.to(device=q.device, dtype=torch.int32).expand(B).contiguous()
    flash_decode(
        q[:, 0], k_cache, v_cache, lengths.to(torch.int32), out,
        scale=scale, window=window, softcap=softcap, key_offset=key_offset, lse=lse,
    )
    LAUNCHES["flash_decode"] += 1
    LAUNCH_SHAPES["flash_decode", decode_shape(q, k_cache, window, softcap)] += 1
    return (out[:, None], lse) if return_lse else out[:, None]


def merge_partials(out: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """The one statement of the shard merge: ``out`` (..., hd) a shard's
    output, normalised over its own keys, and ``lse`` (out's shape without
    hd) its f32 log-sum-exp; ``reduce(t, op)`` reduces ``t`` over the
    shards, op "max" or "sum" (a stacked shard dim, or all-reduces over the
    mesh dims that split the cache, ``layers.decode_merge``).  Each output
    is rescaled by exp(lse_r - max lse) and the sum divided by the rescaled
    sums, in f32; a shard with no key (lse -inf) weighs exactly 0.  Returns
    the outputs' type.  Plain PyTorch: the glue after the kernel."""
    top = reduce(lse, "max")
    w = torch.exp(lse - torch.where(torch.isfinite(top), top, 0.0))[..., None]  # -inf -> 0
    both = reduce(torch.cat([out.float() * w, w], dim=-1), "sum")
    return (both[..., :-1] / both[..., -1:]).to(out.dtype)


def merge_decode_partials(outs: Union[torch.Tensor, Sequence[torch.Tensor]],
                          lses: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    """The attention over a whole cache from its shards' partials
    (``merge_partials`` over a first dim): each shard's output
    (B, 1, H, hd) and log-sum-exp (B, H), stacked along a first dim or as
    sequences."""
    outs = torch.stack(list(outs)) if not isinstance(outs, torch.Tensor) else outs
    lses = torch.stack(list(lses)) if not isinstance(lses, torch.Tensor) else lses

    def over_shards(t, op):
        return t.amax(dim=0, keepdim=True) if op == "max" else t.sum(dim=0)

    return merge_partials(outs, lses.reshape(outs.shape[:-1]), over_shards)


# --------------------------------------------------------------------------
# SSD: the intra-chunk kernel, then the inter-chunk recurrence in PyTorch
# --------------------------------------------------------------------------
def _tpu_layout(x, a, Bm, Cm, Q: int):
    """Model layout -> the TPU kernel's (B, nh, nC, Q, ...) views; B and C
    are broadcast over the heads without a copy."""
    B_, S, nh, hd = x.shape
    N, nC = Bm.shape[-1], S // Q
    return (x.reshape(B_, nC, Q, nh, hd).permute(0, 3, 1, 2, 4),
            a.reshape(B_, nC, Q, nh).permute(0, 3, 1, 2),
            Bm.reshape(B_, 1, nC, Q, N).expand(B_, nh, nC, Q, N),
            Cm.reshape(B_, 1, nC, Q, N).expand(B_, nh, nC, Q, N))


def _intra_chunk(x, a, Bm, Cm, Q: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The intra-chunk block in the kernel's output layout: y_diag
    (B, S, nh, hd), states (B, nC, nh, hd, N), cum (B, S, nh), all f32."""
    B_, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if not x.is_cuda:
        y, st, cum = ref.ssd_intra_chunk_ref(*_tpu_layout(x, a, Bm, Cm, Q))
        return (y.permute(0, 2, 3, 1, 4).reshape(B_, S, nh, hd), st.permute(0, 2, 1, 4, 3),
                cum.permute(0, 2, 3, 1).reshape(B_, S, nh))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(B_, S, nh, hd, **f32)
    st = torch.empty(B_, S // Q, nh, hd, N, **f32)
    cum = torch.empty(B_, S, nh, **f32)
    _ssd_kernel(x, a, Bm, Cm, y, st, cum, chunk=Q)
    LAUNCHES["ssd_intra_chunk"] += 1
    LAUNCH_SHAPES["ssd_intra_chunk", (B_, S, nh, hd, N)] += 1
    return y, st, cum


def chunk_len(S: int, chunk: int) -> int:
    """The chunk the chunked SSD uses for a sequence of S steps: S itself up
    to ``chunk``, else ``chunk``, which must then divide S.  The one place
    that rule is stated; the model's entry checks call it too."""
    if S < 1 or (S > chunk and S % chunk):
        raise ValueError(f"sequence length {S} must be at most the ssm chunk {chunk} "
                         f"or a multiple of it")
    return min(chunk, S)


def ssd_intra_chunk(x, a, Bm, Cm, chunk: int):
    """x (B, S, nh, hd), a (B, S, nh), Bm/Cm (B, S, N) -> the TPU kernel's
    three tensors: y_diag (B,nh,nC,Q,hd), states (B,nh,nC,N,hd), cum
    (B,nh,nC,Q), f32."""
    B_, S, nh, hd = x.shape
    Q = chunk_len(S, chunk)
    if x.is_cuda:
        _refuse_autograd("ssd_intra_chunk", "kernels.ref.ssd_intra_chunk_ref", x, a, Bm, Cm)
    y, st, cum = _intra_chunk(x, a, Bm, Cm, Q)
    nC = S // Q
    return (y.reshape(B_, nC, Q, nh, hd).permute(0, 3, 1, 2, 4), st.permute(0, 2, 1, 4, 3),
            cum.reshape(B_, nC, Q, nh).permute(0, 3, 1, 2))


def ssd(
    x: torch.Tensor,  # (B, S, nh, hd), already multiplied by dt
    a: torch.Tensor,  # (B, S, nh) log decays dt * A
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, nh, hd, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.mamba2.ssd_chunked`` with the intra-chunk block on the kernel.
    Returns (y (B, S, nh, hd) in x's type, final state (B, nh, hd, N) f32)."""
    B_, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nC = S // Q
    if x.is_cuda:
        _refuse_autograd("ssd", "models.mamba2.ssd_chunked", x, a, Bm, Cm, h0)
    y_diag, states, cum = _intra_chunk(x, a, Bm, Cm, Q)
    cum = cum.view(B_, nC, Q, nh)
    chunk_decay = torch.exp(cum[:, :, -1])  # (B, nC, nh)
    h = (torch.zeros(B_, nh, hd, N, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_ins = torch.empty(B_, nC, nh, hd, N, dtype=torch.float32, device=x.device)
    for c in range(nC):  # the state entering each chunk
        h_ins[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    # y_off[b,c,l,h,p] = sum_n C[b,c,l,n] h_in[b,c,h,p,n] * exp(cum[b,c,l,h])
    Cc = Cm.float().reshape(B_, nC, Q, N)
    y_off = torch.matmul(Cc, h_ins.view(B_, nC, nh * hd, N).transpose(-1, -2))
    y_off = y_off.view(B_, nC, Q, nh, hd) * torch.exp(cum)[..., None]
    y = (y_diag.view(B_, nC, Q, nh, hd) + y_off).reshape(B_, S, nh, hd)
    return y.to(x.dtype), h
