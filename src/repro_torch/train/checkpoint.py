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

Both directions hold one leaf on the host at a time.  ``save`` writes each
leaf as its npz member as soon as it is on the host and hashes the bytes as
they go to the file (the members carry data descriptors, and a fixed time
stamp, so a save of the same state is byte-identical to an earlier one);
``restore`` hashes each file in chunks, then reads member by member.

A state on a mesh (DTensor leaves) is saved whole: every rank of the world
calls ``save``, each leaf is gathered over its mesh, rank 0 writes the same
files and manifest as for a state on one device, and the others wait for
its manifest.  ``restore`` reads the files on rank 0 only, which tells
every rank whether the digests held; each leaf then reaches its shards on
the live mesh from rank 0 (``distribute_tensor(..., src_data_rank=0)``).
Rank 0 must stand first on every mesh of the state, as it does on the
elastic trainer's.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import zipfile
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
# The restore hashes a file in chunks of this many bytes.
HASH_CHUNK_BYTES = 64 << 20


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
    to the ledger by the caller).  The leaves go one at a time: each is
    copied to the host, written as its npz member and freed before the
    next, so the host holds one leaf."""
    names, leaves = _leaf_paths(tree)
    if any(isinstance(leaf, DTensor) for leaf in leaves):
        for leaf in leaves:
            _check_source(leaf)
        out = [None]
        if dist.get_rank() == 0:  # each leaf gathered over its mesh, then written
            out[0] = _write(directory, step, names,
                            (_to_numpy(whole(leaf)) for leaf in leaves), meta, n_shards)
        else:
            for leaf in leaves:
                whole(leaf)  # the gathers are collective
        dist.broadcast_object_list(out, src=0)  # the others wait for rank 0's manifest
        return out[0]
    return _write(directory, step, names, (_to_numpy(leaf) for leaf in leaves), meta,
                  n_shards)


class _HashingWriter:
    """A write-only file that hashes what it writes.  It cannot seek, so
    ``zipfile`` writes each member's sizes and CRC after its data (a data
    descriptor) instead of seeking back to patch its header: the bytes hashed
    in order are the file's."""

    def __init__(self, f):
        self._f, self.sha, self._n = f, hashlib.sha256(), 0

    def write(self, data) -> int:
        self.sha.update(data)
        self._n += len(data)
        return self._f.write(data)

    def tell(self) -> int:
        return self._n

    def seek(self, *args):
        raise OSError("not seekable")

    def flush(self) -> None:
        self._f.flush()


def _member(name: str) -> zipfile.ZipInfo:
    """An npz member as ``np.savez`` writes it (stored, not compressed), but
    with a fixed time stamp, so a save of the same state gives the same
    bytes."""
    info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_STORED
    info.external_attr = 0o600 << 16
    return info


def _write(directory: str, step: int, names, arrays, meta, n_shards: int) -> Dict[str, Any]:
    os.makedirs(directory, exist_ok=True)
    entries, files = [], {}
    with contextlib.ExitStack() as stack:
        shards = []
        for shard in range(n_shards):
            path = os.path.join(directory, f"step{step:08d}_shard{shard}.npz")
            writer = _HashingWriter(stack.enter_context(open(path, "wb")))
            shards.append((path, writer, zipfile.ZipFile(writer, mode="w")))
        for i, name in enumerate(names):
            # next() by hand: zip's and enumerate's reused result tuples
            # would keep the last two arrays alive while the next is made
            stored, dtype = next(arrays)
            shard, key = i % n_shards, f"leaf{i}"
            with shards[shard][2].open(_member(key), "w", force_zip64=True) as member:
                np.lib.format.write_array(member, stored, allow_pickle=False)
            entries.append(
                {"name": name, "key": key, "shard": shard, "shape": list(stored.shape),
                 "dtype": dtype})
            del stored
        for shard, (path, writer, zf) in enumerate(shards):
            zf.close()
            files[str(shard)] = {"path": os.path.basename(path),
                                 "sha256_16": writer.sha.hexdigest()[:16]}
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


def _check_source(leaf) -> None:
    """Rank 0 writes and reads the files, so it must stand first on every
    mesh a leaf lives on (the source of each dim's scatter)."""
    if isinstance(leaf, DTensor) and int(leaf.device_mesh.mesh.flatten()[0]) != 0:
        raise ValueError(f"rank 0 is not first on the mesh {leaf.device_mesh}")


def _digest(path: str) -> str:
    sha, chunk = hashlib.sha256(), bytearray(HASH_CHUNK_BYTES)
    view = memoryview(chunk)
    with open(path, "rb", buffering=0) as f:
        while n := f.readinto(chunk):
            sha.update(view[:n])
    return sha.hexdigest()[:16]


def _stored_tensor(z, e) -> torch.Tensor:
    """The member of ``e`` (read now, from the open npz ``z``) as a tensor of
    its stored type."""
    arr = z[e["key"]]
    if list(arr.shape) != list(e["shape"]):
        raise ValueError(f"{e['name']}: stored shape {arr.shape}, manifest {e['shape']}")
    src = torch.from_numpy(arr)
    return src.view(torch.int16).view(torch.bfloat16) if e["dtype"] == BF16 else src


@torch.no_grad()
def restore(directory: str, manifest: Dict[str, Any], like: Any) -> Any:
    """Restores into the tensors of ``like`` in place (a module's
    parameters included, a DTensor's shard on this rank) and returns it.  Validates every shard's digest
    (``IOError``) and every leaf's shape (``ValueError``); each stored
    array is cast to its tensor's type, as the reference casts to the
    type of ``like``.  The files are hashed in chunks and read one member
    at a time, so the host holds one leaf.  On a mesh (DTensor leaves) only
    rank 0 reads the files: every rank of the world raises alike, and each
    leaf reaches its shards from rank 0 (a whole tensor, such as a step
    count, by a broadcast over the world)."""
    names, leaves = _leaf_paths(like)
    by_name = {e["name"]: e for e in manifest["entries"]}
    for name, leaf in zip(names, leaves):
        if list(by_name[name]["shape"]) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: {by_name[name]['shape']} vs "
                             f"{tuple(leaf.shape)}")
    meshed = any(isinstance(leaf, DTensor) for leaf in leaves)
    if meshed:
        for leaf in leaves:
            _check_source(leaf)
    reader = not meshed or dist.get_rank() == 0
    corrupt = [None]
    if reader:
        for shard, info in manifest["files"].items():
            path = os.path.join(directory, info["path"])
            if _digest(path) != info["sha256_16"]:
                corrupt[0] = f"checkpoint shard {shard} corrupt: {path}"
                break
    if meshed:
        dist.broadcast_object_list(corrupt, src=0)
    if corrupt[0] is not None:
        raise IOError(corrupt[0])
    with contextlib.ExitStack() as stack:
        npz = {shard: stack.enter_context(np.load(os.path.join(directory, info["path"])))
               for shard, info in manifest["files"].items()} if reader else {}
        for name, leaf in zip(names, leaves):
            e = by_name[name]
            src = _stored_tensor(npz[str(e["shard"])], e) if reader else None
            if not meshed:
                leaf.copy_(src.to(leaf.dtype))
            elif isinstance(leaf, DTensor):
                if leaf.device_mesh.get_coordinate() is None:
                    continue  # a rank outside this leaf's mesh holds none of it
                local = leaf.to_local()
                if src is None:
                    src = torch.empty(leaf.shape, dtype=leaf.dtype, device=local.device)
                src = distribute_tensor(src.to(local.device, leaf.dtype), leaf.device_mesh,
                                        leaf.placements, src_data_rank=0)
                local.copy_(src.to_local())
            else:  # a whole tensor on every rank of the world
                buf = (src.to(leaf.device, leaf.dtype) if src is not None
                       else torch.empty_like(leaf))
                dist.broadcast(buf, src=0)
                leaf.copy_(buf)
            del src
    return like


def latest_manifest(directory: str) -> Optional[Dict[str, Any]]:
    if not os.path.isdir(directory):
        return None
    manifests = sorted(p for p in os.listdir(directory) if p.endswith(".manifest.json"))
    if not manifests:
        return None
    with open(os.path.join(directory, manifests[-1])) as f:
        return json.load(f)
