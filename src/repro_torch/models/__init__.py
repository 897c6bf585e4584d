"""Model zoo of the port: every family of the JAX package."""

from typing import Union

from .config import ModelConfig
from .encdec import EncDecLM
from .lm import LM


def get_model(cfg: ModelConfig) -> Union[LM, EncDecLM]:
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return LM(cfg)


__all__ = ["ModelConfig", "LM", "EncDecLM", "get_model"]
