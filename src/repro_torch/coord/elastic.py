"""Elastic training: consensus-governed membership driving a live PyTorch loop.

The port of ``repro.coord.elastic``.  ``ElasticTrainer`` welds the three
layers together:

  control plane   ClusterController (Matchmaker MultiPaxos on the
                  deterministic simulator) decides *who is in the
                  cluster* and *what is durable*;
  data plane      the port's train step (``train.make_train_step``),
                  updating the state in place on one device;
  data pipeline   index-based batches (``TokenPipeline.torch_batch_at``),
                  a pure function of the step, so a restore or a
                  membership change replays from any step.

Membership-change flow (the paper's zero-stall reconfiguration mapped to
training):

  1. Leader bumps round s -> s+1 with the new pod set's acceptor config
     (Matchmaking phase; steps keep committing in the old epoch —
     Optimization 1).
  2. The new config is active one round trip later (Phase-1 bypass:
     no step-commit ever stalls — Optimization 2).
  3. The trainer re-meshes onto the new pod set, then continues stepping
     in the new epoch.
  4. Old pods are released only after GC (Scenario 1/2/3) retires their
     acceptor configuration — for planned scale-downs that is a few
     simulated ms after the switch.

Pods are logical on the one device: the control plane, the pipeline and
the checkpoints see the pod set, and the state stays where it is.  That is
the reference's collapse when it has fewer devices than pods, and its
single-device run records the same events.  Sharding the state over many
devices (the reference's ``state_specs``) waits for ``models/sharding.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..core.proposer import Options
from ..models.config import ModelConfig
from ..train import OptConfig, checkpoint, init_state, make_train_step
from ..train.data import DataConfig, TokenPipeline
from .control_plane import ClusterController


@dataclass
class ElasticConfig:
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_every: int = 10
    commit_every: int = 5  # ledger StepRecord cadence
    # Consensus knobs forwarded to the control plane's ClusterSpec
    # (e.g. Options(batch_max=16) to batch the ledger hot path).
    consensus_options: Optional[Options] = None


class ElasticTrainer:
    """Trains on ``device`` (CUDA unless the caller asks for the CPU)."""

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
        self.losses: List[float] = []
        self.events: List[Dict[str, Any]] = []
        self._remesh(list(pods))

    # ------------------------------------------------------------------
    def _remesh(self, pods: List[str]) -> None:
        self.pods = list(pods)
        self.events.append({"t": "remesh", "step": self.step, "pods": list(pods), "devices": 1})

    # ------------------------------------------------------------------
    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            batch = self.pipeline.torch_batch_at(self.step, device=self.device)
            self.state, metrics = self.step_fn(self.state, batch)
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
        checkpoint.restore(self.ecfg.checkpoint_dir, man, self.state)  # in place
        self.step = man["step"]
        self.events.append({"t": "restore", "step": self.step})
        return True
