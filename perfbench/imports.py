"""What a run may not load: JAX, its libraries, the JAX package ``repro`` and
the repo's JAX-era scripts, compared by whole top-level module names (the
port, ``repro_torch``, begins with ``repro`` and is allowed)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke", "tools")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the loaded
    ones)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))
