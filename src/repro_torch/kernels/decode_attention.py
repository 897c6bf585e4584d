"""Launcher of the hand-written CUDA decode kernel (``csrc/decode_attention.cu``).

``flash_decode`` replaces the Pallas TPU kernel ``decode_attention_bkh``.
It reads the KV cache in place in the model's (B, S, K, hd) layout and the
rows' lengths from device memory, and writes into an output the caller
allocated; it launches on PyTorch's current stream and does not
synchronise.  It runs only on CUDA tensors: the plain version for the CPU is
``ref.decode_attention_ref``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import DTYPES, check_operands

TILE = 64  # keys per tile of the kernel


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def splits(B: int, K: int, S: int, window: Optional[int], sm_count: int) -> Tuple[int, int]:
    """(nsplit, chunk): how many blocks share one row's keys, and how many
    keys (a multiple of TILE) each takes.  Enough splits that the
    B * K * nsplit blocks fill about two waves of the SMs, and no more than
    the keys a row can read have tiles."""
    span = min(S, window) if window else S
    tiles = max(1, math.ceil(span / TILE))
    nsplit = max(1, min(tiles, math.ceil(2 * sm_count / (B * K))))
    chunk = TILE * math.ceil(tiles / nsplit)
    return math.ceil(span / chunk) if span else 1, chunk


def flash_decode(
    q: torch.Tensor,  # (B, H, hd)
    k_cache: torch.Tensor,  # (B, S, K, hd)
    v_cache: torch.Tensor,  # (B, S, K, hd)
    lengths: torch.Tensor,  # (B,) int32, valid entries per row
    out: torch.Tensor,  # (B, H, hd)
    *,
    scale: float,
    window: Optional[int],
    softcap: Optional[float],
) -> None:
    """Launches the kernel.  Each row must hold 1 <= length <= S; a row of
    length 0 is outside the contract."""
    check_operands(q, k_cache, v_cache, out)
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, S, K, hd) or v_cache.shape != k_cache.shape or out.shape != q.shape:
        raise ValueError(
            f"shape mismatch: q {q.shape} cache {k_cache.shape} {v_cache.shape} out {out.shape}"
        )
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths must be a (B,) int32 tensor on the kernel's device")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    nsplit, chunk = splits(B, K, S, window, _sm_count(q.device.index or 0))
    part = None
    if nsplit > 1:
        part = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32, device=q.device)
    strides = [*q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3], *out.stride()[:2]]
    err = _build.library().repro_flash_decode(
        DTYPES[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
        B, H, K, S, nsplit, chunk, *strides, float(scale),
        window or 0, float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_decode")
