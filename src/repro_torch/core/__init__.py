# The paper's primary contribution: Matchmaker Paxos / Matchmaker MultiPaxos
# as a deterministic, event-simulated, fully tested protocol implementation.
# Protocol logic lives in pure-kernel role classes (runtime.ProtocolNode);
# I/O is an exchangeable Transport (sim.Simulator / net.AsyncTransport).
from .acceptor import Acceptor
from . import wire
from .client import Client, PipelinedClient, ShardRouter, shard_of_command
from .deploy import ClusterSpec, Deployment, Shard, build, make_transport
from .fast_paxos import FastAcceptor, FastClient, FastCoordinator
from .horizontal import ConfigChange, HorizontalProposer
from .log import (
    AckTracker,
    CommandLog,
    ExecutionLog,
    SlotOwnership,
    SlotState,
    shard_of_slot,
)
from .matchmaker import Matchmaker
from . import mc
from .mc import MCConfig, MCResult, explore
from .mm_reconfig import MMReconfigCoordinator
from .nemesis import (
    ClockSkew,
    Crash,
    DiskLoss,
    FaultPlane,
    Heal,
    Nemesis,
    Partition,
    Pause,
    Restart,
    Resume,
    Schedule,
    Storm,
    check_invariants,
)
from .net import AsyncTransport
from .tcp import TcpTransport
from .proc import (
    ProcDeployment,
    ProcTransport,
    Supervisor,
    deploy_proc,
    proc_scenario_names,
    run_proc_scenario,
)
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
from .scenarios import (
    SCENARIO_NAMES,
    ScenarioFailure,
    ScenarioResult,
    run_matrix,
    run_scenario,
    shrink_failing_scenario,
    shrink_schedule,
    shrink_timing,
)
from .sim import NetworkConfig, Node, Simulator
from .single import SingleDecreeProposer

__all__ = [
    "AckTracker", "Acceptor", "AsyncTransport", "BatchPolicy", "Broadcast",
    "CancelTimer", "Client", "ClockSkew", "ClusterSpec", "CommandLog",
    "ConfigChange", "Configuration", "Crash", "Deployment", "DiskLoss",
    "ExecutionLog", "FastAcceptor", "FastClient", "FastCoordinator",
    "FaultPlane", "Heal", "HorizontalProposer", "KVStoreSM",
    "MCConfig", "MCResult", "MMReconfigCoordinator", "Matchmaker", "NEG_INF",
    "Nemesis",
    "NetworkConfig", "Node", "NoopSM", "Options", "Oracle", "Partition",
    "Pause", "PipelinedClient", "ProcDeployment", "ProcTransport",
    "ProtocolNode", "Proposer", "QuorumSpec",
    "Replica", "Restart", "Resume", "Round", "SCENARIO_NAMES", "SafetyViolation",
    "ScenarioFailure", "ScenarioResult", "Schedule", "Send", "SetTimer",
    "Shard", "ShardRouter", "Simulator", "SingleDecreeProposer",
    "SlotOwnership", "SlotState", "StateMachine", "Storm", "Supervisor",
    "TcpTransport", "Transport", "build", "check_invariants", "deploy_proc",
    "explore", "initial_round", "make_transport", "max_round", "mc", "on",
    "proc_scenario_names", "run_matrix", "run_proc_scenario", "run_scenario",
    "shard_of_command", "shard_of_slot", "shrink_failing_scenario",
    "shrink_schedule", "shrink_timing", "wire",
]
