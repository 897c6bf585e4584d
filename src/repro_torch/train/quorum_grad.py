"""Gradient quorum: the data-plane analogue of the paper's thriftiness.

The port of ``repro.train.quorum_grad``.  The paper's thrifty leader sends
Phase2A to a *quorum* of acceptors instead of all of them, trading failure
resilience for normal-case cost.  At training scale the same trade appears
as straggler mitigation: the cross-pod gradient reduction proceeds once a
quorum of pods contributed; missing pods' shards are dropped and the mean
is rescaled by the live count (unbiased backup-worker estimator).  The
control plane decides the per-step pod mask through the
Matchmaker-MultiPaxos ledger, so every pod agrees on which gradients were
in the quorum.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

Tensor = torch.Tensor


def quorum_mean(per_pod_grads: Any, pod_mask: Tensor) -> Any:
    """Masked mean over the leading pod axis of every leaf.

    per_pod_grads: (nested) mapping of (P, ...) stacked per-pod gradients.
    pod_mask: (P,) 0/1 — pods in the quorum this step.
    """
    denom = torch.clamp(torch.sum(pod_mask), min=1.0)

    def one(g):
        if isinstance(g, Mapping):
            return {k: one(v) for k, v in g.items()}
        m = pod_mask.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
        return torch.sum(g * m, dim=0) / denom.to(g.dtype)

    return one(per_pod_grads)


def quorum_ok(pod_mask: Tensor, f: int) -> Tensor:
    """A quorum needs all-but-f pods (majority-style threshold)."""
    P = pod_mask.shape[0]
    return torch.sum(pod_mask) >= (P - f)
