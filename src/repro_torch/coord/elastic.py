"""Elastic training: consensus-governed membership driving a live PyTorch loop.

The port of ``repro.coord.elastic``.  ``ElasticTrainer`` welds the three
layers together:

  control plane   ClusterController (Matchmaker MultiPaxos on the
                  deterministic simulator) decides *who is in the
                  cluster* and *what is durable*;
  data plane      the port's train step (``train.make_train_step``) on a
                  (pod, data) device mesh built from the live ranks;
  data pipeline   index-based batches (``TokenPipeline.torch_batch_at``),
                  a pure function of the step, laid out over the live
                  pods, so a restore or a membership change replays from
                  any step.

Membership-change flow (the paper's zero-stall reconfiguration mapped to
training):

  1. Leader bumps round s -> s+1 with the new pod set's acceptor config
     (Matchmaking phase; steps keep committing in the old epoch —
     Optimization 1).
  2. The new config is active one round trip later (Phase-1 bypass:
     no step-commit ever stalls — Optimization 2).
  3. The trainer re-meshes: builds the (pod, data) mesh over the new pods'
     ranks and moves the train state onto it (``state_specs``), then
     continues stepping in the new epoch.
  4. Old pods are released only after GC (Scenario 1/2/3) retires their
     acceptor configuration — for planned scale-downs that is a few
     simulated ms after the switch.

The world is the default process group's ranks (NCCL on CUDA, gloo when
the trainer runs on the CPU), a pod ``devices_per_pod`` of them.  Every
rank runs the same seeded control plane, so all decide alike (checked at
each re-mesh); a rank outside the current mesh skips the step and still
advances the control plane.  With fewer ranks than pods the mesh collapses
to (1, 1) and membership stays logical, as in the reference.  Without a
process group there is no world to mesh: pods are logical on the one
device and the state stays a plain one, as the reference's single-device
run, which records the same events.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..core.proposer import Options
from ..models.config import ModelConfig
from ..models.sharding import Spec, axis_sizes, batch_spec, param_specs, place, set_mesh
from ..train import OptConfig, TrainState, checkpoint, init_state, make_train_step
from ..train.data import DataConfig, TokenPipeline
from ..train.optimizer import AdamState
from ..train.train_loop import place_state
from .control_plane import ClusterController


def _widen(spec: Spec, leaf, mesh_axes: Dict[str, int]) -> Spec:
    """Widen the FSDP axis 'data' to ('pod','data') where divisible —
    ZeRO across the DCN axis for optimizer state."""
    total = mesh_axes.get("pod", 1) * mesh_axes.get("data", 1)
    out = []
    for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * (leaf.dim() - len(spec))):
        if ax == "data" and dim % total == 0 and "pod" in mesh_axes:
            out.append(("pod", "data"))
        else:
            out.append(ax)
    return tuple(out)


def state_specs(
    cfg: ModelConfig, state: TrainState, mesh_axes: Dict[str, int], policy: str = "tp"
) -> TrainState:
    """Specs for the full TrainState, in its structure: params per policy
    (by parameter name), optimizer moments widened to ('pod','data') FSDP
    (ZeRO-1 across DCN), the step counts replicated."""
    params = dict(state.params.named_parameters())
    pspec = param_specs(cfg, params, mesh_axes, policy=policy)
    wide = {k: _widen(pspec[k], p, mesh_axes) for k, p in params.items()}

    def per_param(spec: Spec, node) -> Spec:
        if not isinstance(node, Mapping):
            return spec
        # int8 optimizer state: q (*param_lead, nb, block) / s (..., nb, 1)
        # per param.  The spec is CONGRUENT with the param spec (same axes
        # on the same leading dims; the param's last-dim axis moves to the
        # block-count dim when it still divides) — any other layout forces
        # a reshard between q/s and the gradients.
        q = node["q"]
        base = tuple(spec) + (None,) * (q.dim() - 1 - len(spec))
        last_ax = base[-1] if base else None
        if last_ax is not None:
            axes = last_ax if isinstance(last_ax, tuple) else (last_ax,)
            n = 1
            for a in axes:
                n *= mesh_axes.get(a, 1)
            nb = q.shape[-2]
            if n <= 1 or nb % n != 0:
                last_ax = None
        lead = base[:-1] if base else ()
        qspec = (*lead, last_ax, None)
        return {"q": qspec, "s": qspec}

    def opt_like(moments):
        return {k: per_param(wide[k], node) for k, node in moments.items()}

    return TrainState(
        params=pspec,
        opt=AdamState(m=opt_like(state.opt.m), v=opt_like(state.opt.v), step=()),
        step=(),
    )


@dataclass
class ElasticConfig:
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_every: int = 10
    commit_every: int = 5  # ledger StepRecord cadence
    devices_per_pod: Optional[int] = None  # ranks per pod (None: the world split evenly)
    # Consensus knobs forwarded to the control plane's ClusterSpec
    # (e.g. Options(batch_max=16) to batch the ledger hot path).
    consensus_options: Optional[Options] = None


class ElasticTrainer:
    """Trains on ``device`` (CUDA unless the caller asks for the CPU), on a
    (pod, data) mesh of the default process group's ranks when there is
    one."""

    def __init__(
        self,
        cfg: ModelConfig,
        ocfg: OptConfig,
        dcfg: DataConfig,
        *,
        pods: Sequence[str],
        ecfg: Optional[ElasticConfig] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if dist.is_initialized():
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if dist.get_backend() != backend:
                raise RuntimeError(f"ElasticTrainer on {self.device.type} meshes a {backend} "
                                   f"process group, not {dist.get_backend()}")
        self.cfg, self.ocfg, self.dcfg = cfg, ocfg, dcfg
        self.ecfg = ecfg or ElasticConfig()
        self.pipeline = TokenPipeline(dcfg)
        self.controller = ClusterController(
            pods, seed=seed, options=self.ecfg.consensus_options
        )
        self.step_fn = make_train_step(cfg, ocfg)

        self.state = init_state(
            cfg, ocfg, torch.Generator(self.device).manual_seed(seed), self.device
        )
        self.step = 0
        self.epoch = 0
        self.mesh: Optional[DeviceMesh] = None
        self.losses: List[float] = []
        self.events: List[Dict[str, Any]] = []
        self._remesh(list(pods))

    # ------------------------------------------------------------------
    def _device_groups(self, pods: List[str]) -> torch.Tensor:
        """The ranks of the (pod, data) mesh: the first ``devices_per_pod``
        x len(pods) ranks of the world, a row a pod."""
        world = dist.get_world_size()
        if world < len(pods):
            # Oversubscribed: membership stays logical — the control plane,
            # pipeline sharding and checkpoints all see the pod set; the
            # mesh collapses onto one rank.
            return torch.zeros((1, 1), dtype=torch.int64)
        per = self.ecfg.devices_per_pod or max(1, world // max(len(pods), 1))
        need = per * len(pods)
        if need > world:
            raise ValueError(f"need {need} devices, have {world}")
        return torch.arange(need).reshape(len(pods), per)

    def _remesh(self, pods: List[str]) -> None:
        devices = 1
        if dist.is_initialized():
            seen: List[Any] = [None] * dist.get_world_size()
            dist.all_gather_object(seen, (self.epoch, list(pods)))
            if any(s != seen[0] for s in seen):
                raise RuntimeError(f"ranks disagree on the membership: {seen}")
            groups = self._device_groups(pods)
            # Every rank builds every mesh (its groups are made collectively).
            mesh = DeviceMesh(self.device.type, groups, mesh_dim_names=("pod", "data"))
            specs = state_specs(self.cfg, self.state, axis_sizes(mesh))
            # The first placement is of the same seeded state on every rank;
            # later ones move the live state from the old mesh (rank 0 is in
            # every mesh, so its values reach the ranks that join).
            self.state = place_state(self.state, mesh, specs,
                                     src_data_rank=None if self.mesh is None else 0)
            self.mesh, devices = mesh, groups.numel()
        self.pods = list(pods)
        self.events.append(
            {"t": "remesh", "step": self.step, "pods": list(pods), "devices": devices})

    def in_mesh(self) -> bool:
        """Whether this rank trains: it is in the mesh, or there is none."""
        return self.mesh is None or self.mesh.get_coordinate() is not None

    def _batch(self) -> Dict[str, torch.Tensor]:
        b = self.pipeline.torch_batch_at(self.step, device=self.device)
        if self.mesh is None:
            return b
        spec = batch_spec(self.cfg, tuple(b["tokens"].shape), axis_sizes(self.mesh))
        return {k: place(v, self.mesh, spec) for k, v in b.items()}

    # ------------------------------------------------------------------
    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            if self.in_mesh():
                with set_mesh(self.mesh):
                    self.state, metrics = self.step_fn(self.state, self._batch())
                self.losses.append(float(metrics["loss"]))
            self.step += 1
            # advance the control plane "concurrently"
            self.controller.sim.run_for(0.002)
            if self.step % self.ecfg.commit_every == 0:
                self.controller.commit_step(self.step)
            if self.step % self.ecfg.checkpoint_every == 0:
                self.save_checkpoint()
            # react to membership decided by the ledger
            epoch, pods = self.controller.membership()
            if epoch != self.epoch and pods:
                self.epoch = epoch
                self._remesh(list(pods))

    # ------------------------------------------------------------------
    def scale_to(self, pods: Sequence[str]) -> Dict[str, float]:
        """Planned elastic scale up/down (proactive reconfiguration)."""
        telemetry = self.controller.reconfigure(list(pods))
        self.events.append({"t": "scale", "step": self.step, **telemetry})
        return telemetry

    def fail_and_replace(self, dead: str, replacement: str) -> Dict[str, float]:
        self.controller.fail_pod(dead)
        new_pods = [p if p != dead else replacement for p in self.pods]
        telemetry = self.controller.reconfigure(new_pods)
        self.events.append({"t": "failover", "step": self.step, **telemetry})
        return telemetry

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> None:
        man = checkpoint.save(
            self.ecfg.checkpoint_dir,
            self.step,
            self.state,
            meta={"arch": self.cfg.arch_id, "epoch": self.epoch},
        )
        digest = hashlib.sha256(
            json.dumps(man["files"], sort_keys=True).encode()
        ).hexdigest()[:16]
        self.controller.commit_checkpoint(self.step, digest)

    def restore_latest(self) -> bool:
        man = checkpoint.latest_manifest(self.ecfg.checkpoint_dir)
        if man is None:
            return False
        durable = self.controller.durable_step()
        if man["step"] > durable >= 0:
            # Never restore past the consensus-committed durability point.
            return False
        # in place: on a mesh each rank keeps its shards of the files' values
        checkpoint.restore(self.ecfg.checkpoint_dir, man, self.state)
        self.step = man["step"]
        self.events.append({"t": "restore", "step": self.step})
        return True
