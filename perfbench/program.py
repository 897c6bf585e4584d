"""The system under test, ``repro_torch``, built from a configuration's file.

This is the only module of the harness that names the port's model and
config classes; the traffic kinds drive the port's public entries
(``Engine.generate``, ``make_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import seeded


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration's file: its ``arch``'s
    config with every key of ``model`` set as the file states it."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(config["model"]) - fields
    if unknown:
        raise KeyError(f"{config['name']}: not fields of the port's ModelConfig: {sorted(unknown)}")
    return get_config(config["arch"]).replace(**config["model"])


def reference_sizes(config: Dict[str, Any]) -> Dict[str, Any]:
    """What the plain reference reads: the model's sizes and its constants."""
    return {**config["model"], **config.get("constants", {})}


def build_model(config: Dict[str, Any], seed: int, device):
    """The port's model of ``config`` on ``device``, its weights drawn from
    ``seed`` by the configuration's ``init`` table (in the served type)."""
    from repro_torch.models import get_model

    model = get_model(model_config(config)).to_empty(device=device)
    seeded.fill_module(model, config["init"], seed)
    return model


def leaf_layouts(model: torch.nn.Module):
    """(shapes, dtypes) of every parameter by name, for the reference's
    seeded draws."""
    params = dict(model.named_parameters())
    return ({k: tuple(p.shape) for k, p in params.items()},
            {k: p.dtype for k, p in params.items()})
