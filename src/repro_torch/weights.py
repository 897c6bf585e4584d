"""Moves weights and decode state from the JAX package's trees into the port.

Numpy in, torch out.  The caller turns the JAX tree into numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports jax or
ml_dtypes.  A bfloat16 array is recognised by its dtype's name and crosses
through its 16-bit integer view, as ``repro/train/checkpoint.py`` stores it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def to_tensor(arr: Any) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of the same type."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts to dotted keys: {"blocks": {"attn": {"wq": a}}} ->
    {"blocks.attn.wq": a}, the port's parameter names."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, name + "."))
        else:
            out[name] = val
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copies a JAX ``LM.init`` tree (as numpy) into ``model``'s parameters,
    on the device they already live on.  Raises unless the keys are the
    same and every shape and type matches."""
    flat = flatten(tree)
    params = dict(model.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing}, unexpected {extra}")
    for name, arr in flat.items():
        src, dst = to_tensor(arr), params[name]
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(
                f"{name}: JAX {tuple(src.shape)} {src.dtype} vs port "
                f"{tuple(dst.shape)} {dst.dtype}"
            )
        dst.copy_(src)
    return model


def state_from_jax(tree: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX dense decode state {"pos", "kv": (k, v)} (as numpy) as the
    port's decode state on ``device``."""
    if set(tree) != {"pos", "kv"}:
        raise KeyError(f"decode state keys {sorted(tree)}, expected ['kv', 'pos']")
    k, v = tree["kv"]
    if np.shape(k) != np.shape(v) or len(np.shape(k)) != 5:
        raise ValueError(f"KV caches must both be (L, B, S, K, hd), got {np.shape(k)} {np.shape(v)}")
    pos = to_tensor(np.asarray(tree["pos"], np.int32))
    if pos.shape != (np.shape(k)[1],):
        raise ValueError(f"pos {tuple(pos.shape)} does not match batch {np.shape(k)[1]}")
    return {"pos": pos.to(device), "kv": (to_tensor(k).to(device), to_tensor(v).to(device))}
