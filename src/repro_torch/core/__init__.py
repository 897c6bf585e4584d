"""The port's copy of the Matchmaker MultiPaxos core, as far as the control
plane needs it.

The modules here are byte-for-byte copies of their namesakes in
``repro.core`` (``tests/test_torch_core_copy.py`` holds each equal to its
source): the roles, the simulator transport, the deployment builder that
``coord.control_plane`` drives, and the binary codec (``wire``), which the
router's sealed-batch relay imports on the simulator too.  The rest of the
consensus testbed (the nemesis, the asyncio, TCP and process transports,
the model checker, the scenarios, Fast Paxos, single-decree and horizontal
Paxos) is not copied yet; the lazy imports that reach it
(``Deployment.attach_nemesis``, ``make_transport`` for ``"async"``,
``"tcp"`` and ``"proc"``, ``ClusterSpec.deploy("proc")``) raise
``ModuleNotFoundError``.
"""

from .acceptor import Acceptor
from .client import Client, PipelinedClient, ShardRouter, shard_of_command
from .deploy import ClusterSpec, Deployment, Shard, build, make_transport
from .log import (
    AckTracker,
    CommandLog,
    ExecutionLog,
    SlotOwnership,
    SlotState,
    shard_of_slot,
)
from .matchmaker import Matchmaker
from .mm_reconfig import MMReconfigCoordinator
from .oracle import Oracle, SafetyViolation
from .proposer import Options, Proposer
from .quorums import Configuration, QuorumSpec
from .replica import KVStoreSM, NoopSM, Replica, StateMachine
from .rounds import NEG_INF, Round, initial_round, max_round
from .runtime import (
    BatchPolicy,
    Broadcast,
    CancelTimer,
    ProtocolNode,
    Send,
    SetTimer,
    Transport,
    on,
)
from .sim import NetworkConfig, Node, Simulator

__all__ = [
    "AckTracker", "Acceptor", "BatchPolicy", "Broadcast", "CancelTimer", "Client",
    "ClusterSpec", "CommandLog", "Configuration", "Deployment", "ExecutionLog",
    "KVStoreSM", "MMReconfigCoordinator", "Matchmaker", "NEG_INF", "NetworkConfig",
    "Node", "NoopSM", "Options", "Oracle", "PipelinedClient", "ProtocolNode",
    "Proposer", "QuorumSpec", "Replica", "Round", "SafetyViolation", "Send",
    "SetTimer", "Shard", "ShardRouter", "Simulator", "SlotOwnership", "SlotState",
    "StateMachine", "Transport", "build", "initial_round", "make_transport",
    "max_round", "on", "shard_of_command", "shard_of_slot",
]
