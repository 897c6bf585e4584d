"""Moves weights, decode state and training state between the JAX package's
trees and the port.

Numpy in, torch out (and, for a training state, back).  The caller turns
the JAX tree into numpy arrays (``jax.tree.map(np.asarray, params)``);
nothing here imports jax or ml_dtypes.  A bfloat16 array is recognised by
its dtype's name and crosses through its 16-bit integer view, as
``repro/train/checkpoint.py`` stores it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .models import get_model
from .train.optimizer import AdamState
from .train.train_loop import TrainState


def to_tensor(arr: Any) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a CPU tensor of the same type."""
    arr = np.array(arr, order="C")  # a contiguous copy that keeps a 0-d shape
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Dotted keys to nested dicts, the inverse of ``flatten``."""
    out: Dict[str, Any] = {}
    for name, val in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = val
    return out


def _moment_leaves(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A moment's leaves by dotted name: arrays, or int8 ``{"q", "s"}``
    pairs."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping) and set(val) != {"q", "s"}:
            out.update(_moment_leaves(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _moment_from_jax(tree: Mapping[str, Any], params: Mapping[str, torch.Tensor], which: str,
                     device) -> Dict[str, Any]:
    """One Adam moment (as numpy, nested like the params) under the port's
    parameter names: f32 like each param, or int8 ``{"q", "s"}`` blocks
    along its last dim."""
    leaves = _moment_leaves(tree)
    missing, extra = sorted(set(params) - set(leaves)), sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"{which} keys differ: missing {missing}, unexpected {extra}")
    out: Dict[str, Any] = {}
    for name, p in params.items():
        leaf = leaves[name]
        if isinstance(leaf, Mapping):
            q, s = to_tensor(leaf["q"]), to_tensor(leaf["s"])
            lead = tuple(p.shape[:-1])
            last = p.shape[-1] if p.dim() else 1
            if (q.dtype != torch.int8 or s.dtype != torch.float32 or q.dim() != len(lead) + 2
                    or tuple(q.shape[:-2]) != lead or tuple(s.shape) != (*q.shape[:-1], 1)
                    or not 0 <= q.shape[-2] * q.shape[-1] - last < q.shape[-1]):
                raise ValueError(f"{which}/{name}: int8 blocks q {tuple(q.shape)} {q.dtype}, "
                                 f"s {tuple(s.shape)} {s.dtype} do not fit {tuple(p.shape)}")
            out[name] = {"q": q.to(device), "s": s.to(device)}
        else:
            t = to_tensor(leaf)
            if tuple(t.shape) != tuple(p.shape) or t.dtype != torch.float32:
                raise ValueError(f"{which}/{name}: JAX {tuple(t.shape)} {t.dtype} vs "
                                 f"{tuple(p.shape)} float32")
            out[name] = t.to(device)
    return out


def _step_from_jax(arr, which: str, device) -> torch.Tensor:
    t = to_tensor(np.asarray(arr))
    if t.shape != () or t.dtype != torch.int32:
        raise ValueError(f"{which}: {tuple(t.shape)} {t.dtype}, expected a scalar int32")
    return t.to(device)


def train_state_from_jax(tree: Any, cfg, device="cuda"):
    """A JAX ``TrainState`` (as numpy: ``jax.tree.map(np.asarray, state)``)
    as the port's ``TrainState`` on ``device``: the f32 masters in a model
    of ``cfg`` whose parameters require grad, the Adam moments (f32, or
    int8 ``{"q", "s"}``) and both step counts.  Raises on any key, shape or
    type that differs."""
    dev = resolve_device(device)
    model = get_model(cfg).float().to_empty(device=dev)
    load_jax_params(model, tree.params)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = AdamState(m=_moment_from_jax(tree.opt.m, params, ".opt/.m", dev),
                    v=_moment_from_jax(tree.opt.v, params, ".opt/.v", dev),
                    step=_step_from_jax(tree.opt.step, ".opt/.step", dev))
    return TrainState(params=model, opt=opt, step=_step_from_jax(tree.step, ".step", dev))


def train_state_to_jax(state) -> Any:
    """The reverse of ``train_state_from_jax``: the port's ``TrainState`` as
    numpy in JAX's tree layout (nested dicts by parameter path), in the
    port's ``TrainState`` and ``AdamState`` tuples, whose fields JAX's
    share: ``repro.train.TrainState(params, AdamState(*opt), step)``."""
    def numpy(t):  # a copy: the port updates its state in place
        if isinstance(t, Mapping):
            return {k: numpy(v) for k, v in t.items()}
        return np.array(t.detach().cpu())

    return TrainState(params=_nest(numpy(dict(state.params.named_parameters()))),
                      opt=AdamState(m=_nest(numpy(state.opt.m)), v=_nest(numpy(state.opt.v)),
                                    step=numpy(state.opt.step)),
                      step=numpy(state.step))
