"""PyTorch/CUDA port of the JAX data plane in ``repro``.

The port imports torch and numpy only, never jax or anything of ``repro``;
it keeps its own copy of the configs it needs.  Its entry points run on the
CUDA device unless the caller asks for the CPU.

Importing the package itself loads no torch: the consensus testbed in
``core/`` needs none, and every worker process of its process transport
imports ``repro_torch.core.proc``.
"""

from __future__ import annotations

_DTYPES = ("float32", "bfloat16")


def torch_dtype(name: str):
    """Maps a config's dtype string to the torch dtype."""
    import torch

    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return getattr(torch, name)


def resolve_device(device="cuda"):
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
