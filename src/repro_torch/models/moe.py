"""Mixture-of-Experts FFN with grouped, capacity-bounded one-hot dispatch.

The port of ``repro.models.moe``.  Tokens are split into groups of
``cfg.moe_group_size`` and dispatched within each group through a one-hot
(G, Tg, E, C) tensor; expert weights are (E, D, F) batched products.
Top-2 (grok-1) renormalises the top-k gates; top-1 (llama4-scout) also
sends every token through a shared dense MLP of ``d_ff * n_shared_experts``.
The reference has no MoE kernel, so this is plain PyTorch.

On a mesh (x a DTensor, under ``sharding.set_mesh``) the groups are laid
out over the ('pod','data') axes where their count divides, a group never
split (``route``'s cumulative sum runs over a whole group), and each rank
routes and dispatches its own groups.  The dispatched activations are
pinned as the reference pins them (``_pin``: ``xe`` and ``ye`` with the
experts over 'model' under expert parallelism, ``act(g) * h`` with the
expert FFN width over 'model' otherwise), through ``sharding._constrain``.
The expert products run on each rank's shards (``local_map``): under
expert parallelism (E divides 'model') a rank holds E/model experts whole
and the combine's sum over experts is reduced over 'model'; otherwise
(TP-within-expert) a rank holds an F/model slice of every expert, and
``ye`` is reduced over 'model' at its pin.  The weights are gathered over
the other axes at use.  The aux metrics are means over all groups (DTensor
reductions over the mesh).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from . import sharding
from .config import ModelConfig
from .layers import (_normal, activation_fn, local_with_replicated, mapped, mlp_apply, mlp_init,
                     on_mesh)

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


def _group_size(cfg: ModelConfig, T: int) -> int:
    """The tokens of a group, of T in all: ``min(moe_group_size, T)``,
    which must divide T."""
    Tg = min(cfg.moe_group_size, T)
    assert T % Tg == 0, f"token count {T} not divisible by group size {Tg}"
    return Tg


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
    Tg = _group_size(cfg, T)
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


def _dispatch_combine(r: Routing, dtype) -> Tuple[Tensor, Tensor]:
    """The one-hot dispatch and combine tensors (G, Tg, E, C) of a routing,
    in ``dtype``.  A position past C has no slot: JAX's one_hot gives it a
    zero row, torch's raises, so it takes the extra class C, which is cut
    off.  Both are cast to x's type before the expert products, as the
    reference does: the bf16 rounding of the combine weights is part of
    the result."""
    C = r.capacity
    pos_oh = F.one_hot(r.pos.long().clamp(max=C), C + 1)[..., :C].float()
    dispatch = torch.einsum("gtke,gtkc->gtec", r.onehot, pos_oh * r.keep[..., None])
    combine = torch.einsum("gtk,gtke,gtkc->gtec", r.gates, r.onehot, pos_oh)
    return dispatch.to(dtype), combine.to(dtype)


def _aux(cfg: ModelConfig, probs: Tensor, onehot: Tensor, keep: Tensor) -> Dict[str, Tensor]:
    """The load-balance loss and the dropped share, means over all groups."""
    me = probs.mean(dim=(0, 1))  # mean router probability per expert
    ce = onehot.sum(2).mean(dim=(0, 1))  # share of tokens routed per expert
    return {"moe_lb_loss": cfg.n_experts * torch.sum(me * ce),
            "moe_drop_frac": 1.0 - keep.float().mean()}


def moe_apply(cfg: ModelConfig, p, x: Tensor, *, dropless: bool = False
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux {moe_lb_loss, moe_drop_frac}).

    ``dropless`` sets the capacity to the group size, so no token is
    dropped: the decode step's setting."""
    if isinstance(x, DTensor):
        return _moe_apply_mesh(cfg, p, x, dropless=dropless)
    B, S, D = x.shape
    Tg = _group_size(cfg, B * S)
    # The groups are made once, for the routing and the dispatch, as on a
    # mesh: x's gradient then sums the same terms in the same order there.
    xg = x.reshape(-1, Tg, D)
    r = route(cfg, p["router"], xg, dropless=dropless)
    dispatch, combine = _dispatch_combine(r, x.dtype)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    act = activation_fn(cfg.activation)
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"])
    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    ye = torch.einsum("gecf,efd->gecd", act(g) * h, p["w_out"])
    y = torch.einsum("gtec,gecd->gtd", combine, ye).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, _aux(cfg, r.probs, r.onehot, r.keep)


# --------------------------------------------------------------------------
# On a mesh
# --------------------------------------------------------------------------
def _pin(cfg: ModelConfig, t: Tensor, spec_tail) -> Tensor:
    """The reference's ``pin``: token groups over the dp axes where their
    count divides, then ``spec_tail`` for the other dims, each axis kept
    where it divides its dim."""
    if cfg.sharding_policy == "none":
        return t
    sizes = sharding._mesh_sizes()
    if not sizes:
        return t
    dp = sharding._dp(sizes)
    g_ax = dp if (dp and t.shape[0] % sharding._size(sizes, dp) == 0) else None
    tail = [ax if (ax is None or t.shape[1 + i] % sizes.get(ax, 1) == 0) else None
            for i, ax in enumerate(spec_tail)]
    return sharding._constrain(t, sharding._pad((g_ax, *tail), t.dim()))


def _moe_apply_mesh(cfg: ModelConfig, p, x: DTensor, *, dropless: bool):
    """``moe_apply`` on a DTensor x, laid out as the module's docstring says."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B, S, D = x.shape
    Tg = _group_size(cfg, B * S)
    G, E, Fd = B * S // Tg, cfg.n_experts, p["w_in"].shape[-1]
    sizes = sharding.axis_sizes(mesh)
    dp = sharding._dp(sizes)
    M = sizes.get("model", 1)
    ep = "model" if (M > 1 and E % M == 0) else None
    f_split = ep is None and M > 1 and Fd % M == 0

    # The groups, G over dp where it divides.  Where the batch splits over
    # dp as the groups do, each rank groups its own rows; else x is
    # gathered whole, grouped, and the groups sliced.
    gdp = {a: Shard(0) for a in dp} if (dp and G % sharding._size(sizes, dp) == 0) else {}
    aligned = bool(gdp) and B % sharding._size(sizes, dp) == 0
    rows = on_mesh(mesh, **(gdp if aligned else {}))
    gp = on_mesh(mesh, **gdp)
    xg = mapped(lambda t: t.reshape(-1, Tg, D), rows, (rows,), (rows,), x).redistribute(mesh, gp)

    def local_route(xl, router):
        r = route(cfg, router, xl, dropless=dropless)
        return (*_dispatch_combine(r, xl.dtype), r.probs, r.onehot, r.keep.float())

    dispatch, combine, probs, onehot, keep = local_with_replicated(
        local_route, xg, gp, p["router"], out_placements=(gp,) * 5)
    xe = mapped(lambda d, t: torch.einsum("gtec,gtd->gecd", d, t), gp, (gp, gp), (gp, gp),
                 dispatch, xg)

    # Each product's placements: its inputs', its output's, and the
    # gradients' of its inputs (a weight's is a partial sum over the dims
    # that split the groups).
    if ep:
        xe_p = h_p = ye_p = on_mesh(mesh, **gdp, model=Shard(1))
        w_in_p = w_out_p = on_mesh(mesh, model=Shard(0))
        xe_grad, ye_out = xe_p, ye_p
    elif f_split:
        xe_p = ye_p = gp
        w_in_p, w_out_p = on_mesh(mesh, model=Shard(2)), on_mesh(mesh, model=Shard(1))
        h_p = on_mesh(mesh, **gdp, model=Shard(3))
        xe_grad = ye_out = on_mesh(mesh, **gdp, model=Partial())
    else:
        xe_p = h_p = ye_p = xe_grad = ye_out = gp
        w_in_p = w_out_p = on_mesh(mesh)

    def grad_of(w_p):
        return [Partial() if n in gdp else pl for n, pl in zip(names, w_p)]

    def up(a, w):
        return torch.einsum("gecd,edf->gecf", a, w)

    act = activation_fn(cfg.activation)
    xe = _pin(cfg, xe, (ep, None, None))
    h = mapped(up, h_p, (xe_p, w_in_p), (xe_grad, grad_of(w_in_p)), xe, p["w_in"])
    g = mapped(up, h_p, (xe_p, w_in_p), (xe_grad, grad_of(w_in_p)), xe, p["w_gate"])
    h = _pin(cfg, act(g) * h, (ep, None, "model" if ep is None else None))
    ye = mapped(lambda a, w: torch.einsum("gecf,efd->gecd", a, w), ye_out,
                 (h_p, w_out_p), (h_p, grad_of(w_out_p)), h, p["w_out"])
    ye = _pin(cfg, ye, (ep, None, None))

    # The combine and the groups back to rows, on the rows' layout; under
    # ep each rank sums its own experts' share, a partial sum over 'model'.
    keep_g = gdp if aligned else {}
    comb_p = on_mesh(mesh, **keep_g, **({"model": Shard(2)} if ep else {}))
    ye_in = on_mesh(mesh, **keep_g, **({"model": Shard(1)} if ep else {}))
    y_p = on_mesh(mesh, **keep_g, **({"model": Partial()} if ep else {}))
    y = mapped(lambda c, e: torch.einsum("gtec,gecd->gtd", c, e).reshape(-1, S, D), y_p,
                (comb_p, ye_in), (comb_p, ye_in), combine, ye)
    y = y.redistribute(mesh, x.placements)
    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, _aux(cfg, probs, onehot, keep)
