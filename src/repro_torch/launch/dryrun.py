"""Dry-run: what every (architecture x input-shape x mesh) cell needs of a
device, reckoned on the ``meta`` device.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for a 512-device XLA host mesh and reads its memory, FLOPs,
bytes and collectives from the compiled program.  The port has no
compiler to ask, so each cell is built on ``meta`` (parameters from
``LM(cfg)``, the ``TrainState``, the decode state from ``decode_init``:
shapes only, nothing allocated) and

  * its per-device bytes (parameters, optimizer state, decode state) come
    from the DTensor local shapes of its specs (``models.sharding``,
    ``coord.elastic.state_specs``) on a fake process group of the mesh's
    size (``torch.distributed``'s "fake" backend: ranks without peers);
    ``fits_hbm80g`` holds their sum against the H100's 80 GB.  Activations
    and gradients are not counted;
  * at one device, the step's FLOPs and bytes come from
    ``trace_analysis.count`` of the whole step run once on ``meta`` and give
    the roofline terms on the H100's constants;
  * a cell at 256 or 512 devices runs its step itself on the fake world:
    a train cell (``mesh_train_count``) with the meta state laid out by
    ``state_specs``, the batch by ``batch_spec``, ``grad_specs`` the
    parameters' specs; a serving cell (``mesh_serving_count``) with the
    parameters laid out by ``param_specs(..., "tp")``, the batch by
    ``batch_spec`` and the decode state by ``decode_state_specs``; each
    under ``set_mesh``, where the step contracts each weight on its 'model'
    shard (tensor parallelism, as the reference's ``tp``) and gathers it
    over 'data' only.  ``count`` of that run gives one device's FLOPs
    and bytes (its local ops, as the reference's ``flops_per_device``) and
    the collectives it issues, which ``roofline.collective_traffic``
    charges by 8-GPU node (``mesh.NODE_SIZE``): NVLink inside a node,
    InfiniBand across.

The cells are the reference's: ``production_config`` and ``opt_config``
are its overrides, ``attn_impl="chunked"`` included, so the count is of
the same plain attention that the reference lowers.

Usage:
  python -m repro_torch.launch.dryrun --arch grok_1_314b --shape train_4k [--mesh 1]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..configs import SHAPES, cells, get_config, normalize, shape_applicable
from ..coord.elastic import state_specs
from ..models import get_model
from ..models.config import ModelConfig
from ..models.sharding import (
    axis_sizes,
    batch_spec,
    decode_state_specs,
    param_specs,
    place,
    place_module,
    policy_for,
    set_mesh,
    to_placements,
)
from ..serve import make_prefill_step
from ..train import OptConfig, TrainState, make_train_step
from ..train import optimizer as opt
from ..train.train_loop import place_state
from . import roofline as rl
from .mesh import HBM_BYTES, NODE_SIZE, PRODUCTION_MESHES, make_production_mesh
from .trace_analysis import StepCount, count

# Mesh name -> (shape, axis names); "1" is one device.
MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "1": ((1, 1), ("data", "model")),
    "16x16": PRODUCTION_MESHES[False],
    "2x16x16": PRODUCTION_MESHES[True],
}
NO_TRAFFIC = {"ici": 0.0, "dcn": 0.0, "by_op": {}, "n": 0}


# --------------------------------------------------------------------------
# Production config overrides (the reference's)
# --------------------------------------------------------------------------
def production_config(arch: str, shape: str) -> ModelConfig:
    cfg = get_config(arch)
    kind = SHAPES[shape][2]
    policy = policy_for(cfg, kind)
    over: Dict[str, Any] = dict(
        dtype="bfloat16",
        sharding_policy=policy,
        attn_impl="chunked",  # the plain statement of the flash-attention blocking
        attn_q_chunk=256,
        moe_group_size=512,
    )
    if policy == "fsdp" and kind == "train":
        # Sequence is sharded over 'model' and the vocab over the flat
        # FSDP axis -> per-device logits are tiny; no loss chunking.
        over["loss_seq_chunks"] = 1
        over["attn_q_chunk"] = 64
    elif shape == "train_4k":
        over["loss_seq_chunks"] = 16 if cfg.vocab >= 131072 else 8
    return cfg.replace(**over)


def opt_config(cfg: ModelConfig) -> OptConfig:
    # int8 second moments for the XXL MoE configs: f32 m+v for 314B params
    # does not fit 256 devices; blockwise-8-bit does.
    big = cfg.param_count() > 60e9
    return OptConfig(int8_state=big)


def microbatches(cfg: ModelConfig) -> int:
    if cfg.param_count() > 60e9:
        return 16  # XXL MoE: bound dispatch/dW activation memory
    if cfg.param_count() > 25e9:
        return 4
    if cfg.vocab >= 200_000:
        return 2  # giant-vocab dense: bound logits/embed-grad memory
    return 1


# --------------------------------------------------------------------------
# Meshes on a fake process group
# --------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A process group of ``n`` ranks, this process rank 0, with no peers:
    DTensor lays tensors out over it and moves no data.  Destroyed on exit
    (one world size a process at a time)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(name: str) -> DeviceMesh:
    """The named mesh over the current (fake) world: one "cpu" rank, or the
    production mesh of "cuda" ranks, so that DTensor issues the collectives
    it issues on NCCL (an all-to-all where a CPU mesh gathers); its tensors
    stay on meta."""
    if name == "1":
        shape, axes = MESHES[name]
        return init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return make_production_mesh(multi_pod=name == "2x16x16", device_type="cuda")


def _leaves(tensors: Any, specs: Any) -> Iterator[Tuple[torch.Tensor, Any]]:
    """(tensor, spec) pairs of two trees of one structure, the tensors'
    tree leading (a spec is itself a tuple)."""
    if isinstance(tensors, torch.Tensor):
        yield tensors, specs
    elif isinstance(tensors, dict):
        for k, t in tensors.items():
            yield from _leaves(t, specs[k])
    else:
        for t, s in zip(tensors, specs):
            yield from _leaves(t, s)


def device_bytes(tensors: Any, specs: Any, mesh: DeviceMesh) -> int:
    """Bytes on one device (rank 0) of a tree of tensors laid out by a tree
    of specs: the DTensor local shape of each leaf."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    total = 0
    for t, spec in _leaves(tensors, specs):
        local, _ = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, to_placements(spec, mesh, tuple(t.shape)))
        total += math.prod(local) * t.element_size()
    return total


# --------------------------------------------------------------------------
# Cells, on meta
# --------------------------------------------------------------------------
def meta_train_state(cfg: ModelConfig, ocfg: OptConfig) -> TrainState:
    """``init_state``'s structure on meta: f32 masters, the moments, the
    step counts."""
    model = get_model(cfg).float().requires_grad_(True)
    return TrainState(params=model, opt=opt.init(ocfg, dict(model.named_parameters())),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def _decode_state(cfg: ModelConfig, model, batch: int, seq: int) -> Dict[str, Any]:
    if cfg.family == "encdec":
        memory = torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=model.embed.dtype,
                             device="meta")
        return model.decode_init(batch, seq, memory)
    return model.decode_init(batch, seq)


def train_trees(cfg: ModelConfig, ocfg: OptConfig, policy: str):
    """A training state on meta and its trees: ``(state, trees, specs_for)``;
    ``trees`` maps "params" and "optimizer" (moments and step counts) to
    tensors, ``specs_for(mesh_axes)`` maps the same names to their specs."""
    state = meta_train_state(cfg, ocfg)
    trees = {"params": dict(state.params.named_parameters()),
             "optimizer": (state.opt, state.step)}

    def specs_for(axes):
        s = state_specs(cfg, state, axes, policy)
        return {"params": s.params, "optimizer": (s.opt, s.step)}

    return state, trees, specs_for


def serving_trees(cfg: ModelConfig, batch: int, max_len: int):
    """A served model on meta, its decode state at (batch, max_len), and
    their trees: ``(model, state, trees, specs_for)``, with "params" and
    "decode_state" (tp policy)."""
    model = get_model(cfg)
    params = dict(model.named_parameters())
    state = _decode_state(cfg, model, batch, max_len)
    trees = {"params": params, "decode_state": state}

    def specs_for(axes):
        return {"params": param_specs(cfg, params, axes, "tp"),
                "decode_state": decode_state_specs(cfg, state, axes)}

    return model, state, trees, specs_for


def batch_trees(cfg: ModelConfig, shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """A batch on meta: token ids in int32, the encoder's frames in the
    config's type."""
    return {n: torch.zeros(s, dtype=torch.int32 if n in ("tokens", "targets")
                           else torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                           device="meta")
            for n, s in shapes.items()}


def mesh_train_count(cfg: ModelConfig, ocfg: OptConfig, mesh: DeviceMesh,
                     batch: Dict[str, torch.Tensor], *, microbatches: int = 1,
                     policy: Optional[str] = None) -> StepCount:
    """``count`` of one train step on ``mesh`` (a fake world's, on meta):
    the meta state laid out by ``state_specs``, ``batch`` (meta tensors) by
    ``batch_spec``, the gradients pinned to the parameters' specs, under
    ``set_mesh``: one rank's FLOPs, bytes and collectives."""
    policy = policy or policy_for(cfg, "train")
    sizes = axis_sizes(mesh)
    state = meta_train_state(cfg, ocfg)
    specs = state_specs(cfg, state, sizes, policy)
    state = place_state(state, mesh, specs)
    placed = {n: place(t, mesh, batch_spec(cfg, tuple(t.shape), sizes, policy))
              for n, t in batch.items()}
    step = make_train_step(cfg, ocfg, microbatches=microbatches, grad_specs=specs.params)
    with set_mesh(mesh):
        return count(step, state, placed)


def mesh_serving_count(cfg: ModelConfig, mesh: DeviceMesh, kind: str,
                       batch: Dict[str, torch.Tensor], max_len: int) -> StepCount:
    """``count`` of one serving step on ``mesh`` (a fake world's, on meta):
    the model's parameters laid out by ``param_specs(..., "tp")``, ``batch``
    (meta tensors) by ``batch_spec``, and for a decode step (``kind``
    "decode", one new token against a ``max_len`` cache) the decode state
    born laid out by ``decode_state_specs``, under ``set_mesh``: one rank's
    FLOPs, bytes and collectives."""
    sizes = axis_sizes(mesh)
    model = get_model(cfg)
    place_module(model, mesh, param_specs(cfg, dict(model.named_parameters()), sizes, "tp"))
    placed = {n: place(t, mesh, batch_spec(cfg, tuple(t.shape), sizes, "tp"))
              for n, t in batch.items()}
    with set_mesh(mesh):
        if kind == "prefill":
            return count(make_prefill_step(model, max_len=max_len), placed)
        state = _decode_state(cfg, model, placed["tokens"].shape[0], max_len)
        return count(model.decode_step, state, placed["tokens"])


def build_cell(arch: str, shape: str):
    """The cell on meta: ``(fn, args, trees, specs_for, info)``.  ``fn(*args)``
    is its step; ``trees`` maps "params", "optimizer" or "decode_state",
    and "batch" to tensors, and ``specs_for(mesh_axes)`` maps the same
    names to their specs."""
    cfg = production_config(arch, shape)
    seq, batch, kind = SHAPES[shape]
    policy = policy_for(cfg, kind)
    info: Dict[str, Any] = {"kind": kind, "seq": seq, "batch": batch, "policy": policy}
    if kind == "train":
        ocfg = opt_config(cfg)
        state, trees, state_specs_for = train_trees(cfg, ocfg, policy)
        shapes = {"tokens": (batch, seq), "targets": (batch, seq)}
        if cfg.family == "encdec":
            shapes["enc_emb"] = (batch, seq, cfg.d_model)
        n_micro = microbatches(cfg)
        fn = make_train_step(cfg, ocfg, microbatches=n_micro)
        info.update(microbatches=n_micro, tokens=batch * seq,
                    model_flops=6 * cfg.param_count(active_only=True) * batch * seq)
    else:  # serving paths: params in bf16, no optimizer
        model, state, trees, state_specs_for = serving_trees(cfg, batch, seq)
        if kind == "prefill":
            shapes = {"tokens": (batch, seq)}
            if cfg.family == "encdec":
                shapes["enc_emb"] = (batch, cfg.enc_len, cfg.d_model)
            fn, n_tokens = make_prefill_step(model, max_len=seq), batch * seq
        else:  # decode: one new token against a seq-long cache
            shapes = {"tokens": (batch, 1)}
            fn, n_tokens = model.decode_step, batch
        info.update(tokens=n_tokens,
                    model_flops=2 * cfg.param_count(active_only=True) * n_tokens)
    trees["batch"] = batch_trees(cfg, shapes)

    def specs_for(axes):
        return {**state_specs_for(axes),
                "batch": {n: batch_spec(cfg, s, axes, policy) for n, s in shapes.items()}}

    inputs = trees["batch"]
    args = {"train": (state, inputs), "prefill": (inputs,),
            "decode": (state, inputs.get("tokens"))}[kind]
    return fn, args, trees, specs_for, info


def cell_bytes(trees, specs_for, mesh: DeviceMesh) -> Dict[str, int]:
    """Per-device bytes of each of the cell's trees on ``mesh``."""
    specs = specs_for(axis_sizes(mesh))
    out = {name: device_bytes(tensors, specs[name], mesh) for name, tensors in trees.items()}
    out["total"] = sum(out.values())
    return out


def one_device_bytes(trees, specs_for) -> Dict[str, int]:
    """``cell_bytes`` on the one-device mesh, in a fake world of one rank."""
    with fake_world(1):
        return cell_bytes(trees, specs_for, make_mesh("1"))


# --------------------------------------------------------------------------
def run_cell(arch: str, shape: str, *, meshes: Sequence[str] = ("16x16",),
             out_dir: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """One artifact for each of ``meshes``; the step is counted once."""
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    base: Dict[str, Any] = {
        "arch": arch,
        "shape": shape,
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
    }
    arts: Dict[str, Dict[str, Any]] = {}
    if not ok:
        for name in meshes:
            arts[name] = {**base, "mesh": name, "skipped": reason}
            _write(arts[name], out_dir)
        print(f"SKIP {arch} {shape}: {reason}")
        return arts

    fn, args, trees, specs_for, info = build_cell(arch, shape)
    one = None  # the whole step on one device, counted once
    for name in meshes:
        n_dev = math.prod(MESHES[name][0])
        on_mesh = n_dev > 1
        t0 = time.time()
        with fake_world(n_dev):
            dmesh = make_mesh(name)
            per_dev = cell_bytes(trees, specs_for, dmesh)
            if on_mesh:
                cfg_p = production_config(arch, shape)
                if info["kind"] == "train":
                    step = mesh_train_count(cfg_p, opt_config(cfg_p), dmesh, trees["batch"],
                                            microbatches=info["microbatches"],
                                            policy=info["policy"])
                else:
                    step = mesh_serving_count(cfg_p, dmesh, info["kind"], trees["batch"],
                                              info["seq"])
        if not on_mesh:
            if one is None:
                t0 = time.time()
                one = (count(fn, *args), time.time() - t0)
            step, count_s = one
        else:
            count_s = time.time() - t0
        traffic = (rl.collective_traffic(step.collectives, n_devices=n_dev, pod_size=NODE_SIZE)
                   if on_mesh else NO_TRAFFIC)
        art = {
            **base, **info, "mesh": name, "n_devices": n_dev,
            "bytes_per_device": per_dev,
            "fits_hbm80g": per_dev["total"] < HBM_BYTES,
            "step_flops": step.flops,
            "step_bytes": step.bytes,
            "count_s": round(count_s, 2),
            "top_ops": step.top_ops(10),
            "useful_flops_ratio": (info["model_flops"] / (step.flops * (n_dev if on_mesh else 1))
                                   if step.flops else 0.0),
            "roofline": rl.roofline_terms(flops_per_device=step.flops,
                                          bytes_per_device=step.bytes, traffic=traffic),
            "collective": traffic,
        }
        if on_mesh:  # the counts are one rank's share of the step on the mesh
            art.update(count_scope="per device", collectives=step.collectives)
        arts[name] = art
        _write(art, out_dir)
        print(rl.summarize_artifact(art))
        print(f"state/device = {per_dev['total'] / 1e9:.2f} GB "
              f"(fits 80G: {art['fits_hbm80g']}); counted in {count_s:.1f}s")
    return arts


def artifact_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{normalize(arch)}__{shape}__{mesh}.json")


def _write(art: Dict[str, Any], out_dir: Optional[str]) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(artifact_path(out_dir, art["arch"], art["shape"], art["mesh"]), "w") as f:
            json.dump(art, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False, choices=list(SHAPES))
    ap.add_argument("--mesh", action="append", choices=list(MESHES),
                    help="repeatable; default 16x16")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for a, s in cells():
            print(a, s)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --list)")
    run_cell(args.arch, args.shape, meshes=args.mesh or ["16x16"], out_dir=args.out)


if __name__ == "__main__":
    main()
