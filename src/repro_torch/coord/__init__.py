"""coord/: the paper -> framework bridge, ported.

Matchmaker MultiPaxos (the port's copy in ``core/``) as the cluster
control plane of the elastic PyTorch trainer: membership epochs =
consensus rounds, checkpoint durability = GC Scenario 3, gradient-quorum
certificates = thriftiness.
"""

from .control_plane import (
    CheckpointCommit,
    ClusterController,
    LedgerSM,
    QuorumRecord,
    ReconfigCommand,
    StepRecord,
)
from .elastic import ElasticConfig, ElasticTrainer, state_specs
from .failure import FailureDetector

__all__ = [
    "CheckpointCommit",
    "ClusterController",
    "ElasticConfig",
    "ElasticTrainer",
    "FailureDetector",
    "LedgerSM",
    "QuorumRecord",
    "ReconfigCommand",
    "StepRecord",
    "state_specs",
]
