"""Launcher of the hand-written CUDA prefill kernel (``csrc/flash_attention.cu``).

``flash_prefill`` replaces the Pallas TPU kernel ``flash_attention_bhsd``.
It reads q, k and v in the model's (B, S, heads, hd) layout through their
strides and writes into an output the caller allocated; it launches on
PyTorch's current stream and does not synchronise.  It runs only on CUDA
tensors: the plain version for the CPU is ``ref.flash_attention_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(*tensors: torch.Tensor) -> None:
    """The checks both kernels share: one CUDA device, one supported type,
    a unit stride in the head dimension, 16-byte aligned rows (the kernels
    move rows 16 bytes at a time) and a supported head size."""
    first = tensors[0]
    per16 = 16 // first.element_size()
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError("kernel operands must be CUDA tensors on one device")
        if t.dtype != first.dtype or t.dtype not in DTYPES:
            raise ValueError(f"kernel operands must all be float32 or bfloat16, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("kernel operands need a unit stride in the head dimension")
        if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:-1]):
            raise ValueError("kernel operands need 16-byte aligned rows")
    if first.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {first.shape[-1]} not in {HEAD_DIMS}")


def flash_prefill(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, K, hd)
    v: torch.Tensor,  # (B, Sk, K, hd)
    out: torch.Tensor,  # (B, Sq, H, hd)
    *,
    scale: float,
    causal: bool,
    window: Optional[int],
    softcap: Optional[float],
) -> None:
    """Launches the kernel.  Every query row must see at least one key;
    a row with none is outside the contract."""
    check_operands(q, k, v, out)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape} out {out.shape}")
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _build.library().repro_flash_prefill(
        DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, K, Sq, Sk, *strides, float(scale), int(causal), window or 0,
        float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_prefill")
