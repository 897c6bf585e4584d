"""Plain f32 training steps of a reference model: the loss, its gradients
and AdamW, from the seeded weights, on the benchmark's rows.

The step as the configuration states it: the mean next-token cross-entropy
over all rows (the microbatches' mean of means: equal sizes), every layer's
gradient by autograd, the global norm clipped to ``clip_norm``, then AdamW
(``b1``, ``b2``, ``eps``, decoupled ``weight_decay``, a linear warm-up to
``lr`` over ``warmup_steps`` and a cosine to ``min_lr_frac`` by
``total_steps``), f32 moments.  The model is the reference module's
(``layer``, ``unembedding``); each layer is recomputed in the backward
(``torch.utils.checkpoint``) and the loss taken over sequence chunks, so
that it fits beside the f32 state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from perfbench import seeded
from perfbench.reference.common import rms_norm

Tensor = torch.Tensor


def lr_at(o: Dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    span = max(o["total_steps"] - o["warmup_steps"], 1)
    t = min(max((step - o["warmup_steps"]) / span, 0.0), 1.0)
    cos = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return o["lr"] * warm * cos


class Params:
    """The reference's f32 leaves, one tensor a layer of a stacked leaf."""

    def __init__(self, init: Dict, shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype],
                 seed: int, device):
        self.shapes = shapes
        self.t: Dict[tuple, Tensor] = {}
        for name, shape in shapes.items():
            for i in self.layers(name):
                one = shape[1:] if i is not None else shape
                self.t[name, i] = seeded.draw_leaf(init, name, one, dtypes[name], device, seed,
                                                   i).float().requires_grad_(True)

    def layers(self, name: str) -> List[Optional[int]]:
        return list(range(self.shapes[name][0])) if seeded.stacked(name) else [None]

    def __call__(self, name: str, layer: Optional[int]) -> Tensor:
        return self.t[name, layer]

    def leaf_norms(self, tensors: Dict[tuple, Tensor]) -> Dict[str, float]:
        """Each leaf's norm over its layers."""
        out = {}
        for name in self.shapes:
            out[name] = math.sqrt(sum(tensors[name, i].double().square().sum().item()
                                      for i in self.layers(name)))
        return out


def _xent_sum(h: Tensor, w: Tensor, t: Tensor, quant) -> Tensor:
    from perfbench.reference.common import mm

    logits = mm(h, w, quant)
    return (torch.logsumexp(logits, dim=-1) - logits.gather(-1, t[..., None])[..., 0]).sum()


def loss(ref, m: Dict, W: Params, tokens: Tensor, targets: Tensor, quant=None,
         chunks: int = 8) -> Tensor:
    """Mean cross-entropy of ``targets`` after ``tokens`` (rows, S)."""
    x = W("embed", None)[tokens]
    for i in range(m["n_layers"]):
        x = checkpoint(ref.layer, m, W, i, x, quant, use_reentrant=False)
    x = rms_norm(x, W("final_norm", None), m["norm_eps"])
    w = ref.unembedding(m, W)
    S = x.shape[1]
    total = sum(checkpoint(_xent_sum, x[:, c * S // chunks:(c + 1) * S // chunks], w,
                           targets[:, c * S // chunks:(c + 1) * S // chunks], quant,
                           use_reentrant=False) for c in range(chunks))
    return total / targets.numel()


def train(ref, m: Dict, init: Dict, shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype],
          seed: int, rows: List[Tensor], o: Dict, microbatches: int, quant: Optional[str] = None,
          keep: Optional[float] = None):
    """``len(rows)`` steps from the seeded weights (drawn in ``dtypes``, the
    model's type, and widened to f32), each on its (B, S + 1)
    rows; returns the losses, each leaf's norm of the first step's clipped
    gradient, and of the parameters' change over the steps.  ``keep`` (a
    planted fault) trains each step on that share of its rows only."""
    dev = rows[0].device
    W = Params(init, shapes, dtypes, seed, dev)
    mom = {k: torch.zeros_like(p) for k, p in W.t.items()}
    vel = {k: torch.zeros_like(p) for k, p in W.t.items()}
    losses, grad_norms = [], None
    for step, r in enumerate(rows, start=1):
        if keep is not None:
            r = r[: max(1, int(r.shape[0] * keep))]
        n = min(microbatches, r.shape[0])
        mb = r.shape[0] // n
        total = 0.0
        for j in range(n):
            part = r[j * mb:(j + 1) * mb]
            lj = loss(ref, m, W, part[:, :-1], part[:, 1:], quant) / n
            lj.backward()
            total += lj.item()
        losses.append(total)
        with torch.no_grad():
            g = {k: p.grad for k, p in W.t.items()}
            gnorm = math.sqrt(sum(x.double().square().sum().item() for x in g.values()))
            s = min(1.0, o["clip_norm"] / (gnorm + 1e-9))
            if step == 1:
                grad_norms = {k: v * s for k, v in W.leaf_norms(g).items()}
            lr = lr_at(o, step)
            b1c, b2c = 1 - o["b1"] ** step, 1 - o["b2"] ** step
            for k, p in W.t.items():
                gs = p.grad * s
                mom[k].mul_(o["b1"]).add_((1 - o["b1"]) * gs)
                vel[k].mul_(o["b2"]).add_((1 - o["b2"]) * gs * gs)
                delta = (mom[k] / b1c) / ((vel[k] / b2c).sqrt() + o["eps"]) + o["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
    del mom, vel
    with torch.no_grad():
        changes = {}
        for name in shapes:
            sq = 0.0
            for i in W.layers(name):
                one = shapes[name][1:] if i is not None else shapes[name]
                p0 = seeded.draw_leaf(init, name, one, dtypes[name], dev, seed, i).float()
                sq += (W(name, i) - p0).double().square().sum().item()
            changes[name] = math.sqrt(sq)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": changes}


def gaps(prog: Dict, ref: Dict, floor_share: float = 1e-3) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of the losses; of the
    first gradient's norms and of the change's norms, the worst leaf's gap
    of norms against the larger of that leaf's reference norm and the
    median leaf's.  Leaves whose reference gradient is under
    ``floor_share`` of the median leaf's are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))

    def worst(p: Dict[str, float], r: Dict[str, float], names) -> float:
        med = sorted(r[k] for k in names)[len(names) // 2]
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in names)

    names = list(ref["grad_norms"])
    gmed = sorted(ref["grad_norms"].values())[len(names) // 2]
    moving = [k for k in names if ref["grad_norms"][k] >= floor_share * gmed]
    return {"loss_gap": loss, "grad_gap": worst(prog["grad_norms"], ref["grad_norms"], names),
            "change_gap": worst(prog["change_norms"], ref["change_norms"], moving)}
