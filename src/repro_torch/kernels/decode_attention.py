"""Launcher of the hand-written CUDA decode kernel (``csrc/decode_attention.cu``).

``flash_decode`` replaces the Pallas TPU kernel ``decode_attention_bkh``.
It reads the KV cache in place in the model's (B, S, K, hd) layout and the
rows' lengths from device memory, and writes into an output the caller
allocated; it launches on PyTorch's current stream and does not
synchronise.  It runs only on CUDA tensors: the plain version for the CPU is
``ref.decode_attention_ref``.

It also runs on a shard of a cache split along its sequence (a device
mesh's rank holds keys [key_offset, key_offset + S) of each row): lengths
and the window stay in global positions, and with ``lse`` it writes each
(row, head)'s log-sum-exp over the shard's keys, which
``ops.merge_decode_partials`` merges.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from . import _build
from .flash_attention import DTYPES, check_operands

MAX_CLUSTER = 16  # blocks in one cluster (above 8 with the non-portable attribute)
MAX_HEADS = 8  # query heads a block serves at most: the live rows of one m16 product
F32_TILE = 64  # keys per tile of the f32 kernel


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, dtype: int, hd: int, cluster: int, heads: int) -> int:
    """Clusters of ``cluster`` blocks the card holds at once (the CUDA
    occupancy calculator, through the library)."""
    with torch.cuda.device(device_index):
        n = _build.library().repro_flash_decode_clusters(dtype, hd, heads, cluster)
    if n < 0:
        raise RuntimeError(f"flash_decode occupancy query failed: cudaError_t {-n}")
    return n


class Plan(NamedTuple):
    """How one call is cut into blocks: ``cluster`` blocks (one thread-block
    cluster) split each row's keys into splits of ``chunk`` keys, walked in
    tiles of ``tile`` keys; ``groups`` blocks each serve ``heads`` query
    heads of a KV head (the last group may serve fewer)."""

    cluster: int
    chunk: int
    tile: int
    groups: int
    heads: int


def tile_keys(hd: int, f32: bool = False) -> int:
    """Keys per tile: 64 in f32 and for bf16 up to hd 64, else 32 (the
    kernel's ring_tile)."""
    return F32_TILE if f32 or hd <= 64 else 32


def plan(B: int, K: int, q_per_kv: int, S: int, hd: int, window: Optional[int],
         resident: Callable[[int, int], int], f32: bool = False) -> Plan:
    """The split plan.  ``resident(cluster, heads)`` is how many clusters of
    that many blocks the card holds at once.

    A decode call moves a few to a few tens of MB, and each block pays a
    fixed latency (reading its row's length, the first loads, the merge), so
    the plan wants every block on the card at once, and as many of them as
    that allows: at 3.35 TB/s and ~1 us of load latency the card needs ~3.4
    MB in flight, ~25 KB an SM, and a block keeps three ring stages in flight
    (~55 KB at hd 64, ~64 KB at hd 160, or its whole split if shorter).  So
    each (batch, KV head, head group) gets the largest cluster, at most
    ``MAX_CLUSTER`` and no more than the longest row has tiles, of which the
    card holds them all at once; a larger cluster would put part of the grid
    in a second wave, and a cluster of more than two blocks packs into the
    GPCs less well than the SM count suggests.  If even one block each does
    not fit, the clusters are of one block.  A row's keys [first, len)
    (first = len - window on local layers, else 0) fall in splits
    [first + i * chunk, first + (i + 1) * chunk) of ranks i < cluster:
    ``split_keys``."""
    groups = math.ceil(q_per_kv / MAX_HEADS)
    heads = math.ceil(q_per_kv / groups)
    groups = math.ceil(q_per_kv / heads)  # no group left without a head
    tile = tile_keys(hd, f32)
    span = min(S, window) if window else S
    pairs = B * K * groups
    cluster = 1
    for c in range(min(MAX_CLUSTER, math.ceil(span / tile)), 1, -1):
        if pairs <= resident(c, heads):
            cluster = c
            break
    chunk = max(1, math.ceil(span / cluster))
    return Plan(math.ceil(max(span, 1) / chunk), chunk, tile, groups, heads)


def device_plan(device: torch.device, dtype: torch.dtype, B: int, K: int, q_per_kv: int,
                S: int, hd: int, window: Optional[int]) -> Plan:
    """The plan of a call on a CUDA device, from the card's own occupancy."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _device_plan(index, DTYPES[dtype], B, K, q_per_kv, S, hd, window)


@functools.lru_cache(maxsize=1024)
def _device_plan(index, dtype, B, K, q_per_kv, S, hd, window) -> Plan:
    return plan(B, K, q_per_kv, S, hd, window, functools.partial(_resident, index, dtype, hd),
                f32=dtype == DTYPES[torch.float32])


def split_keys(p: Plan, length: int, window: Optional[int], rank: int, *, offset: int = 0,
               S: Optional[int] = None) -> range:
    """The keys (local positions) of a row of ``length`` entries (global)
    that block ``rank`` of its cluster reads from a cache of ``S`` entries
    holding global keys [offset, offset + S) (the kernel's block_work)."""
    first = max(0, length - window) if window else 0
    stop = length - offset if S is None else min(S, length - offset)
    begin = max(0, first - offset) + rank * p.chunk
    return range(begin, min(stop, begin + p.chunk))


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
    key_offset: Union[int, torch.Tensor, None] = None,
    lse: Optional[torch.Tensor] = None,  # (B, H) f32
) -> None:
    """Launches the kernel.  A whole cache (no ``key_offset``): each row
    must hold 1 <= length <= S; a row of length 0 is outside the contract.
    A sequence shard: the cache holds global keys [key_offset, key_offset +
    S) of each row (an int, or a (B,) int32 tensor on the kernel's device),
    a row reads those of [length - window, length) that fall there, and a
    row with none gets output 0 (and log-sum-exp -inf).  ``lse``, where
    given, takes each (row, head)'s log-sum-exp over the keys read."""
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
    offsets, offset = None, 0
    if isinstance(key_offset, torch.Tensor):
        if (key_offset.dtype != torch.int32 or key_offset.shape != (B,)
                or key_offset.device != q.device or not key_offset.is_contiguous()):
            raise ValueError("key_offset must be an int or a contiguous (B,) int32 tensor on "
                             "the kernel's device")
        offsets = key_offset
    elif key_offset is not None:
        offset = int(key_offset)
    lse_strides = (0, 0)
    if lse is not None:
        if lse.dtype != torch.float32 or lse.shape != (B, H) or lse.device != q.device:
            raise ValueError("lse must be a (B, H) float32 tensor on the kernel's device")
        lse_strides = lse.stride()
    p = device_plan(q.device, q.dtype, B, K, H // K, S, hd, window)
    strides = [*q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3], *out.stride()[:2],
               *lse_strides]
    err = _build.library().repro_flash_decode_shard(
        DTYPES[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), None if offsets is None else offsets.data_ptr(),
        offset, None if lse is None else lse.data_ptr(), B, H, K, S, p.cluster, p.chunk,
        p.tile, p.heads, *strides, float(scale), window or 0, float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_decode")
