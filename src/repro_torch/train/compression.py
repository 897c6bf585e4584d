"""Int8 error-feedback gradient compression.

The port of ``repro.train.compression``.  Each gradient tensor is quantized
blockwise to int8 before the cross-pod reduction; the quantization
residual is fed back into the next step's gradient (error feedback), which
keeps SGD/Adam convergence (Karimireddy et al., 2019).  A tree is a
(nested) mapping of names to tensors.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch

Tensor = torch.Tensor


def compress(g: Tensor, block: int = 256) -> Tuple[Tensor, Tensor]:
    flat = g.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: Tensor, scale: Tensor, shape) -> Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def _map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a nested mapping and the trees congruent
    with it (whose leaves may be tuples)."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def ef_compress_tree(grads: Any, residuals: Any, block: int = 256):
    """Error-feedback compression over a tree.

    Returns (compressed tree of (q, scale), new residuals).  The caller
    transmits/reduces the compressed form and applies ``decompress_tree``.
    """

    def one(g, r):
        corrected = g.float() + r
        q, s = compress(corrected, block)
        approx = decompress(q, s, g.shape)
        return (q, s), corrected - approx

    out = _map(one, grads, residuals)
    return _map(lambda o: o[0], out), _map(lambda o: o[1], out)


def decompress_tree(comp: Any, like: Any):
    return _map(lambda g, c: decompress(c[0], c[1], g.shape), like, comp)


def zero_residuals(params: Any):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
