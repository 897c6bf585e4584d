"""Training step assembly: loss, grads, optimizer, metrics.

The port of ``repro.train.train_loop``.  The parameters are f32 masters
(the model module's parameters, requiring grad); the forward runs in the
config type, each layer casting its own weights, under per-layer
recomputation (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  Gradients are taken to bf16, accumulated over
microbatches in bf16, and the AdamW update widens them to f32.

Under autograd the models take the reference's plain attention and SSD
(``layers.use_kernel``): the hand-written kernels have no backward, as the
reference's Pallas kernels have no VJP.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from .. import resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from . import optimizer as opt
from .losses import chunked_xent

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: nn.Module  # the model, its parameters the f32 masters
    opt: opt.AdamState
    step: Tensor


def init_state(cfg: ModelConfig, ocfg: opt.OptConfig, generator: torch.Generator,
               device="cuda") -> TrainState:
    """Random weights drawn in the config type, then widened to f32 as the
    reference does, so the masters start bf16-representable.  The generator
    must live on ``device``."""
    dev = resolve_device(device)
    model = get_model(cfg).init(generator, device=dev).float().requires_grad_(True)
    return TrainState(params=model, opt=opt.init(ocfg, dict(model.named_parameters())),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(model: nn.Module, batch: Dict[str, Tensor]):
        inputs = batch if cfg.family == "encdec" else batch["tokens"]
        hidden, aux = model.hidden_states(inputs, with_aux=True, remat=True)
        loss, metrics = chunked_xent(cfg, model, hidden, batch["targets"],
                                     batch.get("loss_mask"))
        if "moe_lb_loss" in aux:
            loss = loss + 0.01 * aux["moe_lb_loss"]
        metrics.update(aux)
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def make_grad_fn(cfg: ModelConfig):
    """(model, batch) -> (loss, metrics, bf16 grads by parameter name): the
    reference's ``grad_fn``, its gradient reduction in bf16."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(model: nn.Module, batch: Dict[str, Tensor]):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[name] = g.to(torch.bfloat16)
            p.grad = None  # one f32 gradient freed as each bf16 one is made
        return loss.detach(), metrics, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig, *, microbatches: int = 1):
    """``(state, batch) -> (state, metrics)``.  ``microbatches > 1`` takes
    the gradient of each contiguous batch slice in turn and sums them in
    bf16, then divides by the count, as the reference's scan does.  The
    state's masters and moments are updated in place; the returned state
    holds them and the next step count."""
    grad_fn = make_grad_fn(cfg)

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        model = state.params
        if microbatches <= 1:
            loss, metrics, grads = grad_fn(model, batch)
        else:
            grads, loss_sum, per_mb = None, 0.0, []
            for i in range(microbatches):
                mb_batch = {k: v[i * (v.shape[0] // microbatches):
                                 (i + 1) * (v.shape[0] // microbatches)]
                            for k, v in batch.items()}
                loss, metrics, g = grad_fn(model, mb_batch)
                if grads is None:  # 0 + g in bf16 is g
                    grads = g
                else:
                    for name, acc in grads.items():
                        acc.add_(g[name])
                loss_sum = loss_sum + loss
                per_mb.append(metrics)
            for acc in grads.values():
                acc.div_(microbatches)
            loss = loss_sum / microbatches
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}

        _, new_opt, opt_metrics = opt.update(ocfg, dict(model.named_parameters()), grads,
                                             state.opt)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(model, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        loss, metrics = loss_fn(model, batch)
        return {**metrics, "loss": loss}

    return eval_step
