"""Launcher of the hand-written CUDA SSD kernel (``csrc/ssd_scan.cu``).

``ssd_intra_chunk`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/ssd_scan.py``).  It reads x (B, S, nh, hd), the log decays
a (B, S, nh) and B, C (B, S, N) in place through their strides (B and C are
column slices of the model's xBC tensor, shared by every head; x, B and C
need 16-byte aligned rows), and writes three f32 outputs that the caller
allocated, contiguous:

  * ``y``      (B, S, nh, hd)       the intra-chunk output y_diag;
  * ``states`` (B, nC, nh, hd, N)   each chunk's end-of-chunk state;
  * ``cum``    (B, S, nh)           the in-chunk cumulative log decays.

It launches on PyTorch's current stream and does not synchronise.  It runs
only on CUDA tensors: the plain version for the CPU is
``ref.ssd_intra_chunk_ref``.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import DTYPES

HEAD_DIMS = (16, 64)
STATE_DIMS = (16, 64, 128)
MAX_CHUNK = 256  # the block holds the chunk's cumulative decays in shared memory


def ssd_intra_chunk(
    x: torch.Tensor,  # (B, S, nh, hd)
    a: torch.Tensor,  # (B, S, nh) f32
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    y: torch.Tensor,  # (B, S, nh, hd) f32
    states: torch.Tensor,  # (B, S // chunk, nh, hd, N) f32
    cum: torch.Tensor,  # (B, S, nh) f32
    *,
    chunk: int,
) -> None:
    """Launches the kernel over chunks of ``chunk`` steps: any chunk of 1 to
    ``MAX_CHUNK`` steps that divides S."""
    operands = (x, a, Bm, Cm, y, states, cum)
    if any(not t.is_cuda or t.device != x.device for t in operands):
        raise ValueError("kernel operands must be CUDA tensors on one device")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B and C must share float32 or bfloat16, got "
                         f"{x.dtype} {Bm.dtype} {Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (a, y, states, cum)):
        raise ValueError("a and the outputs must be float32")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("x, B and C need a unit stride in their last dimension")
    per16 = 16 // x.element_size()
    if any(t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:-1]) for t in (x, Bm, Cm)):
        raise ValueError("x, B and C need 16-byte aligned rows (the kernel reads 16 bytes "
                         "at a time)")
    if not all(t.is_contiguous() for t in (y, states, cum)):
        raise ValueError("the outputs must be contiguous")
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if hd not in HEAD_DIMS or N not in STATE_DIMS or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"head_dim {hd}, state {N}, chunk {chunk}: the kernel takes "
                         f"{HEAD_DIMS}, {STATE_DIMS} and chunks of 1 to {MAX_CHUNK}")
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    want = {"a": (B, S, nh), "B": (B, S, N), "C": (B, S, N), "y": (B, S, nh, hd),
            "states": (B, S // chunk, nh, hd, N), "cum": (B, S, nh)}
    got = {"a": a, "B": Bm, "C": Cm, "y": y, "states": states, "cum": cum}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} is {tuple(got[name].shape)}, expected {shape}")
    err = _build.library().repro_ssd_intra_chunk(
        DTYPES[x.dtype], hd, N, x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), states.data_ptr(), cum.data_ptr(), B, S, nh, chunk,
        *x.stride()[:3], *a.stride(), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd_intra_chunk")
