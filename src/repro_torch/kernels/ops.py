"""The attention kernels in the model's layouts: the API the model layer calls.

For a CUDA tensor each op launches its hand-written kernel, or raises; there
is no fallback.  For a CPU tensor it runs the plain version in ``ref``.
Unlike the JAX wrappers, which transpose q, k and v (and the whole cache on
every decode) into the kernels' layout, the kernels here read the model's
layout through strides.

``LAUNCHES`` counts the kernel launches of each op, so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .decode_attention import flash_decode
from .flash_attention import flash_prefill

LAUNCHES: Dict[str, int] = {"flash_prefill": 0, "flash_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_prefill(q, k, v, out, scale=scale, causal=causal, window=window, softcap=softcap)
    LAUNCHES["flash_prefill"] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, K, hd)
    v_cache: torch.Tensor,  # (B, S, K, hd)
    lengths: torch.Tensor,  # (B,) valid entries per row
    *,
    scale: float,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over the cache; returns (B, 1, H, hd)."""
    if not q.is_cuda:
        out = ref.decode_attention_ref(
            q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), lengths,
            scale=scale, window=window, softcap=softcap,
        )
        return out[:, None]
    out = torch.empty(q.shape[0], q.shape[2], q.shape[3], dtype=q.dtype, device=q.device)
    flash_decode(
        q[:, 0], k_cache, v_cache, lengths.to(torch.int32), out,
        scale=scale, window=window, softcap=softcap,
    )
    LAUNCHES["flash_decode"] += 1
    return out[:, None]
