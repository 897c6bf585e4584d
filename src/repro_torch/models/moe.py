"""Mixture-of-Experts FFN with grouped, capacity-bounded one-hot dispatch.

The port of ``repro.models.moe``.  Tokens are split into groups of
``cfg.moe_group_size`` and dispatched within each group through a one-hot
(G, Tg, E, C) tensor; expert weights are (E, D, F) batched products.
Top-2 (grok-1) renormalises the top-k gates; top-1 (llama4-scout) also
sends every token through a shared dense MLP of ``d_ff * n_shared_experts``.
The reference has no MoE kernel, so this is plain PyTorch; one device, so
the reference's sharding constraints have no counterpart.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal, activation_fn, mlp_apply, mlp_init

Tensor = torch.Tensor


def moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The expert weights' shapes; the router (D, E) is f32 in any type."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"w_in": (E, D, Fd), "w_gate": (E, D, Fd), "w_out": (E, Fd, D)}


@torch.no_grad()
def moe_init(cfg: ModelConfig, generator: torch.Generator, dtype, device,
             out: Optional[Dict] = None) -> Dict:
    """The reference's draws: router N*D^-0.5 in f32, w_in and w_gate
    N*D^-0.5, w_out N*F^-0.5, the shared expert as ``mlp_init``.  Draws
    expert by expert into ``out`` (the layer's tensors) when given: at
    grok-1's width one weight's f32 draw for all experts is 6.4 GB."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if out is None:
        out = {n: torch.empty(s, dtype=dtype, device=device) for n, s in moe_shapes(cfg).items()}
        out["router"] = torch.empty((D, E), dtype=torch.float32, device=device)
    s_in, s_out = D ** -0.5, Fd ** -0.5
    out["router"].copy_(_normal((D, E), s_in, generator, torch.float32, device))
    for name, std in (("w_in", s_in), ("w_gate", s_in), ("w_out", s_out)):
        for e in range(E):
            out[name][e].copy_(_normal(out[name].shape[1:], std, generator, dtype, device))
    if cfg.n_shared_experts:
        fresh = mlp_init(cfg, generator, dtype, device, d_ff=Fd * cfg.n_shared_experts)
        if "shared" not in out:
            out["shared"] = fresh
        else:
            for name, w in fresh.items():
                out["shared"][name].copy_(w)
    return out


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    cap = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)


class Routing(NamedTuple):
    probs: Tensor  # (G, Tg, E) f32 router probabilities
    gates: Tensor  # (G, Tg, k) renormalised gates, zero where dropped
    experts: Tensor  # (G, Tg, k) chosen experts, best first
    onehot: Tensor  # (G, Tg, k, E) f32
    pos: Tensor  # (G, Tg, k) position in the expert's buffer
    keep: Tensor  # (G, Tg, k) bool: pos < capacity
    capacity: int  # C, each expert's buffer in a group


def route(cfg: ModelConfig, router: Tensor, x: Tensor, *, dropless: bool = False,
          experts: Optional[Tensor] = None) -> Routing:
    """The reference's routing of x (B, S, D): the T = B * S tokens in
    groups of ``min(moe_group_size, T)``, which must divide T; router logits
    in f32 (the router upcast, as JAX promotes a bf16 router against f32
    tokens), softmax, top-k, gates renormalised, then each (token, choice)
    placed in its expert's buffer by a cumulative sum of the one-hot choices
    in token order, and dropped past the capacity (the group size when
    ``dropless``).  ``experts`` (G, Tg, k), when given, are the choices in
    place of the top-k, their gates these experts' probabilities: it holds
    two runs to one routing.

    ``torch.topk`` may order tied probabilities differently from
    ``jax.lax.top_k``; with f32 probabilities of random weights ties do not
    occur, and the tests do not depend on them."""
    B, S, D = x.shape
    T = B * S
    Tg = min(cfg.moe_group_size, T)
    assert T % Tg == 0, f"token count {T} not divisible by group size {Tg}"
    G = T // Tg
    capacity = Tg if dropless else _capacity(cfg, Tg)
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(torch.matmul(x.reshape(G, Tg, D).float(), router.float()), dim=-1)
    if experts is None:
        gates, experts = torch.topk(probs, k, dim=-1, sorted=True)
    else:
        gates = probs.gather(-1, experts)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(experts, E).float()  # (G, Tg, k, E)
    flat = onehot.reshape(G, Tg * k, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(G, Tg, k)
    keep = pos < capacity
    return Routing(probs, gates * keep, experts, onehot, pos, keep, capacity)


def moe_apply(cfg: ModelConfig, p, x: Tensor, *, dropless: bool = False
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux {moe_lb_loss, moe_drop_frac}).

    ``dropless`` sets the capacity to the group size, so no token is
    dropped: the decode step's setting."""
    B, S, D = x.shape
    E = cfg.n_experts
    r = route(cfg, p["router"], x, dropless=dropless)
    G, Tg, C = r.probs.shape[0], r.probs.shape[1], r.capacity
    xg = x.reshape(G, Tg, D)

    # One-hot dispatch and combine (G, Tg, E, C).  A position past C has no
    # slot: JAX's one_hot gives it a zero row, torch's raises, so it takes
    # the extra class C, which is cut off.
    pos_oh = F.one_hot(r.pos.long().clamp(max=C), C + 1)[..., :C].float()
    dispatch = torch.einsum("gtke,gtkc->gtec", r.onehot, pos_oh * r.keep[..., None])
    combine = torch.einsum("gtk,gtke,gtkc->gtec", r.gates, r.onehot, pos_oh)

    # Both cast to x's type before the expert products, as the reference
    # does: the bf16 rounding of the combine weights is part of the result.
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)
    act = activation_fn(cfg.activation)
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"])
    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    ye = torch.einsum("gecf,efd->gecd", act(g) * h, p["w_out"])
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ye).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)

    me = r.probs.mean(dim=(0, 1))  # mean router probability per expert
    ce = r.onehot.sum(2).mean(dim=(0, 1))  # share of tokens routed per expert
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_drop_frac": 1.0 - r.keep.float().mean()}
    return y, aux
