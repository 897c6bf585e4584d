"""The port's checkpoint a leaf at a time (``repro_torch.train.checkpoint``).

On the CPU: a save and a restore of 8 leaves of 1 MB each hold at most a
few leaves of host memory (``tracemalloc``, which numpy reports to; the
tensors share their memory with the arrays saved and read); the
manifest's digest is the sha256 of the file's bytes, hashed as they were
written; two saves of one state are byte-identical, a day apart; the JAX
package restores the port's file bit for bit and the port restores JAX's.
On 4 gloo ranks (spawned, joined through a ``FileStore``, importing no
jax): a (2, 2) mesh restores the shards it saved; a (1, 2) mesh of ranks 0
and 1 does too while ranks 2 and 3, outside it, make the same calls; a
corrupt file raises ``IOError`` on every rank; ranks other than 0 never
read the files.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.train import checkpoint

LEAF_BYTES = 1 << 20
N_LEAVES = 8
WORLD = 4
RANKS_TIMEOUT_S = 120.0


def leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {f"w{i}": torch.from_numpy(rng.standard_normal(LEAF_BYTES // 4).astype(np.float32))
            for i in range(N_LEAVES)}


def test_save_and_restore_hold_few_leaves(tmp_path, monkeypatch):
    """Peak traced host memory under 3 leaves each way (the code before held
    the whole file at least twice on each).  A leaf on a card is copied to
    the host before it is written: here a numpy copy stands in for that
    copy, so that tracemalloc sees it (a CPU tensor's array is the tensor's
    own memory).  The hash's chunk is a constant, not a leaf: here a
    quarter of one."""
    monkeypatch.setattr(checkpoint, "HASH_CHUNK_BYTES", LEAF_BYTES // 4)
    to_numpy = checkpoint._to_numpy
    monkeypatch.setattr(checkpoint, "_to_numpy",
                        lambda leaf: (lambda a, dtype: (a.copy(), dtype))(*to_numpy(leaf)))
    tree = leaves()
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    tracemalloc.start()
    try:
        man = checkpoint.save(str(tmp_path), 1, tree)
        save_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        checkpoint.restore(str(tmp_path), man, like)
        restore_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert save_peak < 3 * LEAF_BYTES, save_peak
    assert restore_peak < 3 * LEAF_BYTES, restore_peak
    for k, v in tree.items():
        assert torch.equal(like[k], v), k


def test_manifest_digest_is_the_files_sha256(tmp_path):
    man = checkpoint.save(str(tmp_path), 2, leaves(), n_shards=3)
    assert len(man["files"]) == 3
    for info in man["files"].values():
        data = (tmp_path / info["path"]).read_bytes()
        assert hashlib.sha256(data).hexdigest()[:16] == info["sha256_16"]


def test_saves_of_one_state_are_byte_identical(tmp_path, monkeypatch):
    tree = leaves()
    first = checkpoint.save(str(tmp_path / "a"), 3, tree, n_shards=2)
    real = time.time
    monkeypatch.setattr(time, "time", lambda: real() + 86400)  # a day later
    second = checkpoint.save(str(tmp_path / "b"), 3, tree, n_shards=2)
    assert first == second
    for info in first["files"].values():
        assert (tmp_path / "a" / info["path"]).read_bytes() == (
            tmp_path / "b" / info["path"]).read_bytes()


def test_both_packages_restore_each_other(tmp_path):
    """f32 and bf16 leaves over two shards, bit for bit both ways."""
    import jax.numpy as jnp
    from repro.train import checkpoint as jckpt

    rng = np.random.default_rng(1)
    f32 = {"a": rng.standard_normal((64, 48)).astype(np.float32),
           "c": rng.standard_normal((7,)).astype(np.float32)}
    bf = rng.standard_normal((32, 16)).astype(np.float32)
    port = {"a": torch.from_numpy(f32["a"]), "b": torch.from_numpy(bf).to(torch.bfloat16),
            "c": torch.from_numpy(f32["c"])}
    jtree = {"a": jnp.asarray(f32["a"]), "b": jnp.asarray(bf).astype(jnp.bfloat16),
             "c": jnp.asarray(f32["c"])}

    def bits(x):
        x = np.asarray(x)
        return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)

    man = checkpoint.save(str(tmp_path / "t"), 4, port, n_shards=2)
    back = jckpt.restore(str(tmp_path / "t"), man, {k: jnp.zeros_like(v) for k, v in jtree.items()})
    for k, v in jtree.items():
        assert np.array_equal(bits(back[k]), bits(v)), k
    jman = jckpt.save(str(tmp_path / "j"), 4, jtree, n_shards=2)
    like = {k: torch.zeros_like(v) for k, v in port.items()}
    checkpoint.restore(str(tmp_path / "j"), jman, like)
    for k, v in port.items():
        assert torch.equal(like[k].view(torch.int16) if v.dtype == torch.bfloat16 else like[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16 else v), k


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------
def _mesh_tree(mesh, seed):
    """DTensors of several layouts on ``mesh`` (each rank keeps its shard of
    the same seeded values) and a whole step count."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rng = np.random.default_rng(seed)
    full = {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)),
            "v": torch.from_numpy(rng.standard_normal((4, 10)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((6,)).astype(np.float32)).bfloat16()}
    layouts = {"w": (Shard(0), Shard(1)), "v": (Replicate(), Shard(0)),
               "b": (Replicate(), Replicate())}
    layouts = {k: p[:mesh.ndim] for k, p in layouts.items()}
    tree = {k: distribute_tensor(t, mesh, layouts[k]) for k, t in full.items()}
    tree["step"] = torch.tensor(seed + 7, dtype=torch.int32)
    return tree


def _zeros_like(tree):
    from torch.distributed.tensor import DTensor, distribute_tensor

    return {k: distribute_tensor(torch.zeros(v.shape, dtype=v.dtype), v.device_mesh, v.placements)
            if isinstance(v, DTensor) else torch.zeros_like(v) for k, v in tree.items()}


def _same(a, b) -> bool:
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        a, b = a.to_local(), b.to_local()
    return bool(torch.equal(a, b))


def _rank(rank: int, tmp: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        if rank != 0:  # only rank 0 reads the files
            def forbidden(*args, **kwargs):
                raise AssertionError(f"rank {rank} read a checkpoint file")

            checkpoint._digest = forbidden
            np.load = forbidden
        out = {}
        square = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                            mesh_dim_names=("pod", "data"))
        tree = _mesh_tree(square, 0)
        man = checkpoint.save(os.path.join(tmp, "square"), 1, tree)
        like = checkpoint.restore(os.path.join(tmp, "square"), man, _zeros_like(tree))
        out["square"] = {k: _same(like[k], tree[k]) for k in tree}
        # a mesh of ranks 0 and 1: ranks 2 and 3 hold no shard, call alike
        pair = DeviceMesh("cpu", torch.tensor([[0, 1]]), mesh_dim_names=("pod", "data"))
        tree = _mesh_tree(pair, 1)
        man2 = checkpoint.save(os.path.join(tmp, "pair"), 2, tree)
        like = checkpoint.restore(os.path.join(tmp, "pair"), man2, _zeros_like(tree))
        out["pair"] = {k: _same(like[k], tree[k]) for k in tree
                       if pair.get_coordinate() is not None or k == "step"}
        if rank == 0:
            path = os.path.join(tmp, "square", man["files"]["0"]["path"])
            with open(path, "r+b") as f:
                f.seek(-7, os.SEEK_END)
                f.write(b"garbage")
        dist.barrier()
        try:
            checkpoint.restore(os.path.join(tmp, "square"), man, _zeros_like(_mesh_tree(square, 0)))
            out["corrupt"] = "restored"
        except IOError as e:
            out["corrupt"] = f"IOError: {e}"
        with open(os.path.join(tmp, f"out{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt_ranks"))
    ctx = mp.start_processes(_rank, args=(tmp,), nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in {RANKS_TIMEOUT_S} s")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"out{r}.json")) as f:
            out.append(json.load(f))
    return out


def test_mesh_restores_its_shards(ranks):
    for r, out in enumerate(ranks):
        assert out["square"] == {"w": True, "v": True, "b": True, "step": True}, (r, out)


def test_ranks_outside_the_mesh_call_alike(ranks):
    for r, out in enumerate(ranks):
        want = ({"w": True, "v": True, "b": True, "step": True} if r < 2 else {"step": True})
        assert out["pair"] == want, (r, out)


def test_corrupt_file_raises_on_every_rank(ranks):
    for r, out in enumerate(ranks):
        assert out["corrupt"].startswith("IOError: checkpoint shard 0 corrupt"), (r, out)
