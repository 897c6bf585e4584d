"""Production mesh construction and the NVIDIA H100's constants.

The port of ``repro.launch.mesh``.  A FUNCTION (not a module-level mesh),
so importing this module touches no process group: the caller starts the
world (``torch.distributed.init_process_group``, or a fake group for the
dry-run) first.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ('data', 'model') mesh, or (2, 16, 16) ('pod', 'data',
    'model') with ``multi_pod``, over the current world.  Raises unless the
    world has exactly that many ranks: the mesh is never shrunk."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                           f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# NVIDIA H100 SXM5 80GB at its 700 W power limit, per GPU, from NVIDIA's
# H100 Tensor Core GPU data sheet (dense rates, without sparsity) unless
# stated; used by the roofline analysis and chip_smoke.py's bounds.
PEAK_BF16_FLOPS = 989e12  # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": 67e12}  # f32 off the tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
HBM_BYTES = 80e9  # HBM3 capacity
L2_BYTES = 50e6  # L2 cache (NVIDIA's Hopper architecture whitepaper)
ICI_BW = 450e9  # B/s a direction: NVLink 4, 900 GB/s both directions a GPU
DCN_BW = 50e9  # B/s: one 400 Gb/s InfiniBand NDR port a GPU (the DGX H100 layout)
# GPUs that share NVLink: a DGX H100 node.  A collective whose group spans
# two nodes is charged to DCN_BW (roofline.collective_traffic's pod_size).
NODE_SIZE = 8
