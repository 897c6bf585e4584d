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
    """Copies a JAX ``LM.init`` or ``EncDecLM.init`` tree (as numpy) into
    ``model``'s parameters, on the device they already live on.  Raises
    unless the keys are the same and every shape and type matches (an MoE
    tree's router is f32 beside bf16 experts, and so is the port's)."""
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


def _kv_from_jax(kv, name: str, device):
    k, v = kv
    if np.shape(k) != np.shape(v) or len(np.shape(k)) != 5:
        raise ValueError(f"{name} caches must both be (n, B, S, K, hd), got "
                         f"{np.shape(k)} {np.shape(v)}")
    return to_tensor(k).to(device), to_tensor(v).to(device)


# The decode state's keys in each family: dense and MoE, SSM, hybrid,
# encoder-decoder.
_STATE_KEYS = ({"pos", "kv"}, {"pos", "ssm"}, {"pos", "ssm", "shared_kv"},
               {"pos", "kv", "xk", "xv"})


def state_from_jax(tree: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX decode state (as numpy) as the port's decode state on
    ``device``: dense ``{"pos", "kv": (k, v)}``, SSM ``{"pos", "ssm": {"h",
    "conv"}}``, hybrid the SSM keys plus ``"shared_kv": (k, v)``,
    encoder-decoder the dense keys plus the cross-attention K/V ``"xk"``,
    ``"xv"`` (L, B, S_enc, K, hd)."""
    if set(tree) not in _STATE_KEYS:
        raise KeyError(f"decode state keys {sorted(tree)}, expected one of "
                       f"{[sorted(k) for k in _STATE_KEYS]}")
    pos = to_tensor(np.asarray(tree["pos"], np.int32))
    state: Dict[str, Any] = {"pos": pos.to(device)}
    if "kv" in tree:
        state["kv"] = _kv_from_jax(tree["kv"], "KV", device)
        batch = state["kv"][0].shape[1]
        if "xk" in tree:
            state["xk"], state["xv"] = _kv_from_jax((tree["xk"], tree["xv"]), "cross KV",
                                                    device)
            if state["xk"].shape[:2] != state["kv"][0].shape[:2]:
                raise ValueError(f"cross KV {tuple(state['xk'].shape)} does not match the "
                                 f"self-attention caches {tuple(state['kv'][0].shape)}")
    else:
        ssm = tree["ssm"]
        if set(ssm) != {"h", "conv"}:
            raise KeyError(f"ssm state keys {sorted(ssm)}, expected ['conv', 'h']")
        h, conv = to_tensor(ssm["h"]), to_tensor(ssm["conv"])
        if h.dim() != 5 or conv.dim() != 4 or h.shape[:2] != conv.shape[:2]:
            raise ValueError(f"ssm state must be h (L, B, nh, hd, N) and conv (L, B, W-1, C), "
                             f"got {tuple(h.shape)} {tuple(conv.shape)}")
        state["ssm"] = {"h": h.to(device), "conv": conv.to(device)}
        batch = h.shape[1]
        if "shared_kv" in tree:
            state["shared_kv"] = _kv_from_jax(tree["shared_kv"], "shared KV", device)
    if pos.shape != (batch,):
        raise ValueError(f"pos {tuple(pos.shape)} does not match batch {batch}")
    return state
