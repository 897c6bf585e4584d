"""Model zoo of the port: the dense and VLM families so far."""

from .config import ModelConfig
from .lm import LM

# Families that later slices port, with the ROADMAP.md item that ports each.
_LATER = {
    "moe": "Queue 1 item 6 (models/moe.py)",
    "ssm": "Queue 1 item 7 (models/mamba2.py and the SSM paths of lm.py)",
    "hybrid": "Queue 1 item 7 (models/mamba2.py and the SSM paths of lm.py)",
    "encdec": "Queue 1 item 8 (models/encdec.py)",
}


def get_model(cfg: ModelConfig) -> LM:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: ROADMAP.md {_LATER[cfg.family]}"
        )
    return LM(cfg)


__all__ = ["ModelConfig", "LM", "get_model"]
