"""Training substrate of the port: optimizer, losses, data, checkpointing,
train step, gradient quorum and int8 error-feedback compression."""

from . import checkpoint, compression, data, losses, optimizer, quorum_grad, train_loop
from .optimizer import OptConfig
from .train_loop import TrainState, init_state, make_eval_step, make_train_step

__all__ = [
    "OptConfig",
    "TrainState",
    "checkpoint",
    "compression",
    "data",
    "init_state",
    "losses",
    "make_eval_step",
    "make_train_step",
    "optimizer",
    "quorum_grad",
    "train_loop",
]
