"""AdamW + warmup-cosine schedule + global-norm clipping.

The port of ``repro.train.optimizer``, with the same functions and the
same f32 arithmetic in the same order.  A "tree" here is a flat mapping of
parameter names to tensors (``dict(model.named_parameters())``); the
moments are f32 tensors under the same names, or with ``int8_state``
blockwise int8 ``{"q", "s"}`` pairs.  ``update`` writes the new parameters
and moments into the given tensors in place: at full width a second copy
of the f32 masters or moments would not fit beside the first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

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


def global_norm(tree: Mapping[str, Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


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
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        if cfg.int8_state:
            m_f = _dq8(m["q"], m["s"], p.shape)
            v_f = _dq8(v["q"], v["s"], p.shape)
        else:
            m_f, v_f = m, v
        # The reference's expressions, op for op: b1*m + (1-b1)*g,
        # b2*v + ((1-b2)*g)*g, then mh / (sqrt(vh) + eps) + wd*p.
        m_f = m_f.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_f = v_f.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = torch.div(v_f, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(m_f, b1c).div_(delta).add_(cfg.weight_decay * p.float())
        p.sub_(delta.mul_(lr))
        if cfg.int8_state:
            qm, sm = _q8(m_f, cfg.int8_block)
            qv, sv = _q8(v_f, cfg.int8_block)
            new_m[name], new_v[name] = {"q": qm, "s": sm}, {"q": qv, "s": sv}
        else:
            new_m[name], new_v[name] = m_f, v_f
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(m=new_m, v=new_v, step=step), metrics
