"""AdamW + warmup-cosine schedule + global-norm clipping.

The port of ``repro.train.optimizer``, with the same functions and the
same f32 arithmetic in the same order.  A "tree" here is a flat mapping of
parameter names to tensors (``dict(model.named_parameters())``); the
moments are f32 tensors under the same names, or with ``int8_state``
blockwise int8 ``{"q", "s"}`` pairs.  ``update`` writes the new parameters
and moments into the given tensors in place: at full width a second copy
of the f32 masters or moments would not fit beside the first.

On a mesh the masters, moments and gradients are DTensors: the update runs
elementwise on each rank's shards, op for op as on one device, and the
global norm sums each rank's local squares over the mesh.  With
``int8_state`` the ``q``/``s`` pairs are laid out as
``coord.elastic.state_specs`` gives them (the moment's lead dims as the
parameter's, its last dim's split on the block-count dim where it
divides); a rank dequantises, updates and requantises its own shard where
that shard is a whole number of the reference's blocks of the whole
tensor (the last dim whole, or split where it is a multiple of the
block), and elsewhere gathers the last dim first and keeps its slice of
the new ``q``/``s``: the same blocks, so the same bits, as on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Tensor = torch.Tensor


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    int8_state: bool = False  # blockwise 8-bit m/v (beyond-paper)
    int8_block: int = 256


def schedule(cfg: OptConfig, step: Tensor) -> Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


# -- blockwise int8 state compression ----------------------------------------
# Blocks run along the LAST dim only, keeping the leading dims intact (in
# the reference, so that their shardings survive).
def _q8(x: Tensor, block: int) -> Tuple[Tensor, Tensor]:
    *lead, last = x.shape if x.dim() else (1,)
    x2 = x.reshape(*lead, last)
    pad = (-last) % block
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
    nb = (last + pad) // block
    xb = x2.reshape(*lead, nb, block)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: Tensor, scale: Tensor, shape) -> Tensor:
    xb = q.float() * scale  # (*lead, nb, block)
    *lead, nb, block = xb.shape
    last = shape[-1] if len(shape) else 1
    flat = xb.reshape(*lead, nb * block)
    if nb * block != last:
        flat = flat[..., :last]
    return flat.reshape(shape)


def _q8_layout(q: Tensor, shape, block: int):
    """The placements, over the moment's dims, of a rank's share of the f32
    moment whose int8 ``q`` is ``q``: q's own (its lead dims are the
    moment's, its block-count dim stands for the moment's last), with a
    split of the last dim kept only where that dim is a whole number of
    blocks, so each shard is whole blocks; None for a plain ``q``."""
    if not isinstance(q, DTensor):
        return None
    last = len(shape) - 1
    return [Replicate() if (isinstance(pl, Shard) and pl.dim == last and shape[-1] % block)
            else pl for pl in q.placements]


def _q8_into(x: Tensor, like: Mapping[str, Tensor], lay, block: int) -> Dict[str, Tensor]:
    """``x`` (a rank's share of the moment in ``lay``) quantised, laid out
    as ``like``'s ``q`` and ``s``."""
    q, s = _q8(x, block)
    if lay is None:
        return {"q": q, "s": s}
    out = {}
    for key, t in (("q", q), ("s", s)):
        ref = like[key]
        d = DTensor.from_local(t, ref.device_mesh, lay, run_check=False, shape=ref.shape,
                               stride=ref.stride())
        out[key] = d.redistribute(ref.device_mesh, ref.placements)
    return out


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: Tensor


def init(cfg: OptConfig, params: Mapping[str, Tensor]) -> AdamState:
    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.int8_state:
            q, s = _q8(z, cfg.int8_block)
            return {"q": q, "s": s}
        return z

    device = next(iter(params.values())).device
    return AdamState(
        m={k: zero(p) for k, p in params.items()},
        v={k: zero(p) for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _square_sum(g: Tensor) -> Tensor:
    """The sum of the squares of ``g``'s elements that this rank counts: on
    a mesh its shard's, on the ranks at coordinate 0 of every mesh dim that
    replicates ``g`` (a replicated element is counted once), else 0."""
    if not isinstance(g, DTensor):
        return torch.sum(torch.square(g.float()))
    if any(p.is_partial() for p in g.placements):
        raise ValueError(f"global_norm: a partial gradient ({g.placements}); redistribute it")
    s = torch.sum(torch.square(g.to_local().float()))
    coord = g.device_mesh.get_coordinate()
    if any(p.is_replicate() and c != 0 for p, c in zip(g.placements, coord)):
        return torch.zeros_like(s)
    return s


def global_norm(tree: Mapping[str, Tensor]) -> Tensor:
    """The L2 norm of every tensor of ``tree``; on a mesh, from each rank's
    local squares, summed over the mesh."""
    total = sum(_square_sum(g) for g in tree.values())
    mesh = next((g.device_mesh for g in tree.values() if isinstance(g, DTensor)), None)
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def _local(t: Tensor, placements) -> Tensor:
    """``t``'s shard in ``placements`` on this rank (a plain tensor is its
    own)."""
    if not isinstance(t, DTensor):
        return t
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(t.device_mesh, placements)
    return t.to_local()


def _local_like(g: Tensor, p: Tensor) -> Tensor:
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def update(
    cfg: OptConfig, params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
    state: AdamState,
) -> Tuple[Mapping[str, Tensor], AdamState, Dict[str, Tensor]]:
    """params are the f32 masters, grads any float type (bf16 from the
    train step); returns (params, new state, {"grad_norm", "lr"}) with the
    params and f32 moments updated in place."""
    if set(grads) != set(params):
        raise KeyError(f"grads {sorted(set(grads) ^ set(params))} do not match the params")
    # A gradient on a mesh in another layout than its master's (a partial
    # sum, from a DTensor op's backward) is reduced to it here, in its type.
    grads = {k: _local_like(g, params[k]) for k, g in grads.items()}
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    new_m, new_v = {}, {}
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        # On a mesh the update runs on the moments' shards (ZeRO: they may
        # split what the parameter replicates), the gradient and the
        # master resharded to them; the master's new values go back to
        # its own layout.
        if cfg.int8_state:
            lay = _q8_layout(m["q"], p.shape, cfg.int8_block)
        else:
            lay = m.placements if isinstance(m, DTensor) else getattr(p, "placements", None)
        g = _local(grads[name], lay).float() * scale
        p_l = _local(p, lay)
        if cfg.int8_state:
            m_f = _dq8(_local(m["q"], lay), _local(m["s"], lay), p_l.shape)
            v_f = _dq8(_local(v["q"], lay), _local(v["s"], lay), p_l.shape)
        else:
            m_f, v_f = _local(m, lay), _local(v, lay)
        # The reference's expressions, op for op: b1*m + (1-b1)*g,
        # b2*v + ((1-b2)*g)*g, then mh / (sqrt(vh) + eps) + wd*p.
        m_f = m_f.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_f = v_f.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = torch.div(v_f, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(m_f, b1c).div_(delta).add_(cfg.weight_decay * p_l.float())
        delta.mul_(lr)
        if isinstance(p, DTensor) and tuple(p.placements) != tuple(lay):
            delta = DTensor.from_local(delta, p.device_mesh, lay, run_check=False,
                                       shape=p.shape, stride=p.stride())
            delta = delta.redistribute(p.device_mesh, p.placements).to_local()
        p_l = p.to_local() if isinstance(p, DTensor) else p
        p_l.sub_(delta)
        if cfg.int8_state:
            new_m[name] = _q8_into(m_f, m, lay, cfg.int8_block)
            new_v[name] = _q8_into(v_f, v, lay, cfg.int8_block)
        else:
            new_m[name], new_v[name] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(m=new_m, v=new_v, step=step), metrics
