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

On a mesh (``place_state``, then the step under ``sharding.set_mesh``) the
masters, moments and batch are DTensors; ``grad_specs`` pins the bf16
gradients to the parameters' layout, and the metrics come back whole.

Tracing (``repro_torch.tracing``): a step is the span ``train.step``; each
microbatch's gradient and its bf16 accumulation ``train.grad`` (attribute
``i``); the optimizer's update, called through the module attribute
``optimizer.update``, ``train.update``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .. import resolve_device, tracing
from ..models import get_model
from ..models.config import ModelConfig
from ..models.sharding import Spec, place, place_module, to_placements, whole
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


def _map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(tensor, spec)`` over a moments tree (name -> tensor, or an int8
    ``{"q", "s"}`` pair) and its specs."""
    if isinstance(tree, Mapping):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def place_state(state: TrainState, mesh: DeviceMesh, specs: TrainState, *,
                src_data_rank: Optional[int] = None) -> TrainState:
    """``state`` laid out on ``mesh`` by ``specs`` (``state_specs``'s): the
    masters and moments become DTensors in place, one tensor at a time
    (``sharding.place``, which also moves a state between meshes,
    ``src_data_rank`` as there); the step counts stay whole tensors on
    every rank, and with a ``src_data_rank`` the mesh's ranks take its
    counts (a rank that was outside the old mesh took no steps there)."""
    def move(t: Tensor, spec: Spec) -> DTensor:
        return place(t, mesh, spec, src_data_rank=src_data_rank)

    def count(t: Tensor) -> Tensor:
        if src_data_rank is None or mesh.get_coordinate() is None:
            return t
        return move(t, (None,) * t.dim()).to_local()

    place_module(state.params, mesh, specs.params, src_data_rank=src_data_rank)
    for which in ("m", "v"):
        moments, wanted = getattr(state.opt, which), getattr(specs.opt, which)
        for k in list(moments):
            moments[k] = _map_specs(move, moments[k], wanted[k])
    return TrainState(state.params, state.opt._replace(step=count(state.opt.step)),
                      count(state.step))


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


def _pin(g: Tensor, grad_specs: Optional[Mapping[str, Spec]], name: str) -> Tensor:
    """``g`` laid out by ``grad_specs[name]`` on its mesh (a DTensor), else
    ``g``."""
    if grad_specs is None or not isinstance(g, DTensor):
        return g
    mesh = g.device_mesh
    return g.redistribute(mesh, to_placements(grad_specs[name], mesh, g.shape))


def make_grad_fn(cfg: ModelConfig, grad_specs: Optional[Mapping[str, Spec]] = None):
    """(model, batch) -> (loss, metrics, bf16 grads by parameter name): the
    reference's ``grad_fn``.  With ``grad_specs`` (``param_specs``'s, by
    parameter name) each bf16 gradient on a mesh is laid out as its
    parameter: a partial sum is reduced there, in bf16, as the reference's
    cross-device gradient sum.  (A parameter gathered at use gets its
    gradient back in its own layout, reduced in f32 by the gather's
    backward.)"""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(model: nn.Module, batch: Dict[str, Tensor]):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[name] = _pin(g.to(torch.bfloat16), grad_specs, name)
            p.grad = None  # one f32 gradient freed as each bf16 one is made
        return whole(loss), {k: whole(v) for k, v in metrics.items()}, grads

    return grad_fn


def _microbatch(t: Tensor, i: int, n: int) -> Tensor:
    """Rows [i B/n, (i+1) B/n) of ``t``; on a mesh laid out as ``t``."""
    mb = t.shape[0] // n
    part = t[i * mb:(i + 1) * mb]
    if isinstance(t, DTensor):
        part = part.redistribute(t.device_mesh, t.placements)
    return part


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig, *, microbatches: int = 1,
                    grad_specs: Optional[Mapping[str, Spec]] = None):
    """``(state, batch) -> (state, metrics)``.  ``microbatches > 1`` takes
    the gradient of each contiguous batch slice in turn and sums them in
    bf16, then divides by the count, as the reference's scan does.  The
    state's masters and moments are updated in place; the returned state
    holds them and the next step count.  ``grad_specs`` (``param_specs``'s,
    by parameter name) pins the bf16 gradients on a mesh to the parameter
    layout, the sum of the microbatches' and their mean too."""
    grad_fn = make_grad_fn(cfg, grad_specs)
    grad_attrs = [{"i": i} for i in range(max(1, microbatches))]  # built once, for the spans

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        with tracing.span("train.step"):
            model = state.params
            if microbatches <= 1:
                with tracing.span("train.grad", grad_attrs[0]):
                    loss, metrics, grads = grad_fn(model, batch)
            else:
                grads, loss_sum, per_mb = None, 0.0, []
                for i in range(microbatches):
                    mb_batch = {k: _microbatch(v, i, microbatches) for k, v in batch.items()}
                    with tracing.span("train.grad", grad_attrs[i]):
                        loss, metrics, g = grad_fn(model, mb_batch)
                        if grads is None:  # 0 + g in bf16 is g
                            grads = g
                        else:
                            for name, acc in grads.items():
                                acc.add_(g[name])
                    loss_sum = loss_sum + loss
                    per_mb.append(metrics)
                for name, acc in grads.items():
                    grads[name] = _pin(acc.div_(microbatches), grad_specs, name)
                loss = loss_sum / microbatches
                metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}

            with tracing.span("train.update"):
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
