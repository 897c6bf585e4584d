"""Model zoo of the port: the dense, VLM, SSM and hybrid families so far."""

from .config import ModelConfig
from .lm import LM

# Families that later slices port, with the ROADMAP.md item that ports each.
_LATER = {
    "moe": "Queue 1 item 6 (models/moe.py)",
    "encdec": "Queue 1 item 8 (models/encdec.py)",
}


def get_model(cfg: ModelConfig) -> LM:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: ROADMAP.md {_LATER[cfg.family]}"
        )
    return LM(cfg)


__all__ = ["ModelConfig", "LM", "get_model"]
