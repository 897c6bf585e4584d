"""Sharded checkpoints with consensus-committed manifests.

The port of ``repro.train.checkpoint``, in the same format: one ``.npz``
per host shard of the flattened tree plus a JSON manifest {step, entries
(name, npz key, shard, shape, dtype), files (name, ``sha256_16`` digest),
n_shards, meta}.  A checkpoint counts only once its manifest is chosen in
the cluster ledger and replicated on f+1 replicas (the paper's GC
Scenario 3 applied to training state).

Leaves are named as JAX names a tree's paths: a NamedTuple's field as
``.field``, a mapping's key as itself, joined by ``/`` (a
``TrainState``'s leaves are ``.params/blocks/attn/wq``,
``.opt/.m/embed/q``, ``.opt/.step``, ``.step``), and taken in JAX's order
(mapping keys sorted); a module stands for the mapping of its parameters,
and a dotted name (``blocks.attn.wq``) for the nested keys it spells.  So a
checkpoint written by either package restores in the other.

A state on a mesh (DTensor leaves) is saved whole: every rank of the world
calls ``save``, each leaf is gathered over its mesh, rank 0 writes the same
files and manifest as for a state on one device, and the others wait for
its manifest.  ``restore`` reads the files on every rank and keeps each
leaf's shard on the live mesh.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.sharding import whole

# npz cannot store bfloat16: it crosses as its uint16 view, under the dtype
# name JAX writes.
BF16 = "bfloat16"


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _flatten(getattr(tree, field), path + ("." + field,))
    elif isinstance(tree, nn.Module):
        yield from _flatten(dict(tree.named_parameters()), path)
    elif isinstance(tree, Mapping):
        for key in sorted(tree, key=lambda k: tuple(str(k).split("."))):
            yield from _flatten(tree[key], path + tuple(str(key).split(".")))
    else:
        yield path, tree


def _leaf_paths(tree: Any):
    flat = list(_flatten(tree))
    return ["/".join(path) for path, _ in flat], [leaf for _, leaf in flat]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the dtype name of the manifest)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(
    directory: str,
    step: int,
    tree: Any,
    *,
    meta: Optional[Dict[str, Any]] = None,
    n_shards: int = 1,
) -> Dict[str, Any]:
    """Write a sharded checkpoint; returns the manifest (to be committed
    to the ledger by the caller)."""
    names, leaves = _leaf_paths(tree)
    if any(isinstance(leaf, DTensor) for leaf in leaves):
        writer = dist.get_rank() == 0
        arrays = []
        for leaf in leaves:  # each gathered over its mesh, one at a time
            full = whole(leaf)
            arrays.append(_to_numpy(full) if writer else None)
            del full
        out = [_write(directory, step, names, arrays, meta, n_shards) if writer else None]
        dist.broadcast_object_list(out, src=0)  # the others wait for rank 0's manifest
        return out[0]
    return _write(directory, step, names, [_to_numpy(leaf) for leaf in leaves], meta, n_shards)


def _write(directory: str, step: int, names, arrays, meta, n_shards: int) -> Dict[str, Any]:
    os.makedirs(directory, exist_ok=True)
    shards: Dict[int, Dict[str, np.ndarray]] = {i: {} for i in range(n_shards)}
    entries = []
    for i, (name, (stored, dtype)) in enumerate(zip(names, arrays)):
        shard = i % n_shards
        key = f"leaf{i}"
        shards[shard][key] = stored
        entries.append(
            {"name": name, "key": key, "shard": shard, "shape": list(stored.shape),
             "dtype": dtype}
        )
    files = {}
    for shard, blobs in shards.items():
        path = os.path.join(directory, f"step{step:08d}_shard{shard}.npz")
        np.savez(path, **blobs)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        files[str(shard)] = {"path": os.path.basename(path), "sha256_16": digest}
    manifest = {
        "step": step,
        "entries": entries,
        "files": files,
        "n_shards": n_shards,
        "meta": meta or {},
    }
    mpath = os.path.join(directory, f"step{step:08d}.manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    return manifest


@torch.no_grad()
def restore(directory: str, manifest: Dict[str, Any], like: Any) -> Any:
    """Restores into the tensors of ``like`` in place (a module's
    parameters included, a DTensor's shard on this rank) and returns it.  Validates every shard's digest
    (``IOError``) and every leaf's shape (``ValueError``); each stored
    array is cast to its tensor's type, as the reference casts to the
    type of ``like``."""
    names, leaves = _leaf_paths(like)
    blobs = {}
    for shard, info in manifest["files"].items():
        path = os.path.join(directory, info["path"])
        with open(path, "rb") as f:
            data = f.read()
        digest = hashlib.sha256(data).hexdigest()[:16]
        if digest != info["sha256_16"]:
            raise IOError(f"checkpoint shard {shard} corrupt: {path}")
        with np.load(path) as z:
            for k in z.files:
                blobs[(int(shard), k)] = z[k]
    by_name = {e["name"]: e for e in manifest["entries"]}
    for name, leaf in zip(names, leaves):
        e = by_name[name]
        arr = blobs[(e["shard"], e["key"])]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(leaf.shape)}")
        src = torch.from_numpy(arr.copy())
        if e["dtype"] == BF16:
            src = src.view(torch.int16).view(torch.bfloat16)
        if isinstance(leaf, DTensor):  # this rank's shard, read from its own copy
            src = distribute_tensor(src.to(leaf.dtype), leaf.device_mesh, leaf.placements,
                                    src_data_rank=None)
            leaf.to_local().copy_(src.to_local())
        else:
            leaf.copy_(src.to(leaf.dtype))
    return like


def latest_manifest(directory: str) -> Optional[Dict[str, Any]]:
    if not os.path.isdir(directory):
        return None
    manifests = sorted(p for p in os.listdir(directory) if p.endswith(".manifest.json"))
    if not manifests:
        return None
    with open(os.path.join(directory, manifests[-1])) as f:
        return json.load(f)
