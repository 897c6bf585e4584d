"""Pieces shared by the plain references: f32 with TF32 off, and the fp8 control.

``quant="fp8"`` is the control of the output check: every projection takes
its input (per row) and its weight (per output column) rounded to
float8_e4m3fn with a scale to its largest magnitude, the nearest precision
below the bf16 the configurations state, and multiplies them in f32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
# One layer's leaf in f32: weights(name, layer) -> tensor (layer None for an
# unstacked leaf such as the embedding).
Weights = Callable[[str, Optional[int]], Tensor]

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@torch.no_grad()
def _fp8(t: Tensor, dim: int) -> Tensor:
    """``t`` rounded to float8_e4m3fn, scaled per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float().mul_(scale)


class _Fp8Matmul(torch.autograd.Function):
    """x @ w on both rounded to fp8; the backward passes the gradient
    straight through the rounding, and keeps only the rounded operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, -1), _fp8(w, 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gx = g @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw


def mm(x: Tensor, w: Tensor, quant: Optional[str] = None) -> Tensor:
    """x (..., k) @ w (k, n), f32; with ``quant="fp8"`` both rounded first."""
    if quant == "fp8":
        return _Fp8Matmul.apply(x, w)
    if quant is not None:
        raise ValueError(f"unknown quantization {quant!r}")
    return x @ w


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """x / rms(x) * (1 + scale)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def silu(x: Tensor) -> Tensor:
    return F.silu(x)
