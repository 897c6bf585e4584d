"""One config per assigned architecture (exact, from the assignment table)
plus reduced smoke-test variants.

``get_config(arch_id)`` returns the full config; ``get_smoke_config`` a
small same-family variant for CPU tests.  ``SHAPES`` holds the assigned
input-shape set; ``cells()`` enumerates the 40 (arch x shape) dry-run
cells, applying the assignment's skip rules (long_500k only for
sub-quadratic archs).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "grok_1_314b",
    "llama4_scout_17b_a16e",
    "gemma2_2b",
    "stablelm_12b",
    "starcoder2_15b",
    "gemma3_4b",
    "zamba2_1p2b",
    "mamba2_2p7b",
    "seamless_m4t_large_v2",
    "chameleon_34b",
]

# Assigned shapes: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def normalize(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(arch_id)}")
    return mod.SMOKE_CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Assignment skip rules.  Returns (runnable, reason-if-not)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.arch_id} is pure full-attention (skip per assignment)"
        )
    return True, ""


def cells() -> List[Tuple[str, str]]:
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            out.append((a, s))
    return out


def runnable_cells() -> List[Tuple[str, str]]:
    out = []
    for a, s in cells():
        ok, _ = shape_applicable(get_config(a), s)
        if ok:
            out.append((a, s))
    return out
