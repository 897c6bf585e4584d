"""The port's launch tooling against the reference's, on the CPU.

* The dry-run's cells are the reference's (configs, optimizer settings,
  microbatches), and its per-device bytes of parameters, optimizer state,
  decode state and batch equal the reckoning of the reference's specs on
  its abstract states (``jax.eval_shape``), for every runnable cell on the
  single-pod and multi-pod meshes.  A cell's artifact has the dry-run's
  keys; a skipped cell says why; ``dryrun_all`` writes one artifact a cell
  and mesh.
* ``trace_analysis.count``'s FLOPs equal ``hlo_analysis.analyze``'s for
  ``apply`` on the smoke configs of the dense, MoE, SSM, hybrid and
  encoder-decoder families, and for one smoke train step, each by the
  relation stated beside it.
* ``collective_traffic`` and ``roofline_terms`` equal the reference's on the
  same inputs, the hardware constants set equal on both sides; by 8-GPU
  node, a group inside one node is charged to NVLink and one across two to
  InfiniBand.
* A cell on 256 devices, train or serving: the step run on the fake world
  gives one device's FLOPs and bytes and a numeric collective term; a
  decode cell whose caches split their sequence (stablelm-12b's
  decode_32k at 16 x 16) charges the merge of the ranks' partials.
* ``read_profile`` on a CPU profile of a smoke decode step and on a
  synthetic trace with known kernels, launches and overlaps.
* ``make_production_mesh`` builds only over a world of its size.
* The launch modules, and the fake process group they open, import
  neither jax nor ``repro``.
* The router's sealed-batch relay runs on the port's simulator as on the
  reference's (it needs the codec, ``core/wire.py``).
"""

import importlib
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from repro.configs import get_smoke_config as jax_smoke_config
from repro.coord.elastic import state_specs as jax_state_specs
from repro.launch import hlo_analysis
from repro.launch import roofline as jax_roofline
from repro.models import get_model as jax_get_model
from repro.models import sharding as jax_sharding
from repro.serve.engine import make_prefill_step as jax_make_prefill_step
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import SHAPES, get_smoke_config, runnable_cells
from repro_torch.launch import dryrun, dryrun_all, mesh, roofline, trace_analysis
from repro_torch.models import get_model
from repro_torch.train import OptConfig, init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _jax_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS`` for
    a 512-device host platform; that is put back at once, so that no later
    JAX initialisation in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


jax_dryrun = _jax_dryrun()
MESH_AXES = {"16x16": {"data": 16, "model": 16},
             "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# --------------------------------------------------------------------------
# Dry-run
# --------------------------------------------------------------------------
def _reckon(shapes, specs, axes) -> int:
    """Bytes on one device of a JAX tree laid out by a spec tree: each dim
    over the product of its axes, rounded up as JAX pads it."""
    total = 0
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    flat = jax.tree.leaves(shapes)
    assert len(flat_specs) == len(flat)
    for leaf, spec in zip(flat, flat_specs):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for dim, e in zip(leaf.shape, entries):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= -(-dim // math.prod(axes[a] for a in names))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def jax_cell_bytes(arch, shape, axes):
    """The reference's per-device bytes of a cell: its build_cell's abstract
    states under its specs."""
    cfg = jax_dryrun.production_config(arch, shape)
    seq, batch, kind = SHAPES[shape]
    policy = jax_sharding.policy_for(cfg, kind)
    sds = jax.ShapeDtypeStruct
    trees = {}
    if kind == "train":
        state = jax.eval_shape(
            lambda: jax_init_state(cfg, jax_dryrun.opt_config(cfg), jax.random.PRNGKey(0)))
        specs = jax_state_specs(cfg, state, axes, policy=policy)
        trees["params"] = (state.params, specs.params)
        trees["optimizer"] = ((state.opt, state.step), (specs.opt, specs.step))
        inputs = {"tokens": sds((batch, seq), jnp.int32), "targets": sds((batch, seq), jnp.int32)}
        if cfg.family == "encdec":
            inputs["enc_emb"] = sds((batch, seq, cfg.d_model), jnp.bfloat16)
    else:
        model = jax_get_model(cfg)
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        trees["params"] = (params, jax_sharding.param_specs(cfg, params, axes, policy="tp"))
        if kind == "prefill":
            inputs = {"tokens": sds((batch, seq), jnp.int32)}
            if cfg.family == "encdec":
                inputs["enc_emb"] = sds((batch, cfg.enc_len, cfg.d_model), jnp.bfloat16)
            state = jax.eval_shape(jax_make_prefill_step(cfg), params, inputs)[1]
        else:
            inputs = {"tokens": sds((batch, 1), jnp.int32)}
            if cfg.family == "encdec":
                mem = sds((batch, cfg.enc_len, cfg.d_model), jnp.bfloat16)
                state = jax.eval_shape(lambda p, m: model.decode_init(p, batch, seq, m),
                                       params, mem)
            else:
                state = jax.eval_shape(lambda: model.decode_init(batch, seq))
        trees["decode_state"] = (state, jax_sharding.decode_state_specs(cfg, state, axes))
    trees["batch"] = (inputs, {k: jax_sharding.batch_spec(cfg, v.shape, axes, policy)
                               for k, v in inputs.items()})
    out = {k: _reckon(s, sp, axes) for k, (s, sp) in trees.items()}
    out["total"] = sum(out.values())
    return out


@pytest.fixture(scope="module")
def cells_built():
    return {cell: dryrun.build_cell(*cell) for cell in runnable_cells()}


def test_cells_are_the_reference_cells():
    from repro.configs import runnable_cells as jax_runnable_cells

    assert runnable_cells() == jax_runnable_cells()
    for arch, shape in runnable_cells():
        cfg, jcfg = dryrun.production_config(arch, shape), jax_dryrun.production_config(arch, shape)
        assert cfg.__dict__ == jcfg.__dict__
        assert dryrun.opt_config(cfg).__dict__ == jax_dryrun.opt_config(jcfg).__dict__
    assert {dryrun.opt_config(dryrun.production_config(a, "train_4k")).int8_state
            for a in ("grok_1_314b", "llama4_scout_17b_a16e")} == {True}


@pytest.mark.parametrize("mesh_name", list(MESH_AXES))
def test_dryrun_bytes_match_the_reference(cells_built, mesh_name):
    axes = MESH_AXES[mesh_name]
    with dryrun.fake_world(math.prod(axes.values())):
        dmesh = dryrun.make_mesh(mesh_name)
        for cell, (_, _, trees, specs_for, _) in cells_built.items():
            got = dryrun.cell_bytes(trees, specs_for, dmesh)
            assert got == jax_cell_bytes(*cell, axes), cell
    assert not torch.distributed.is_initialized()


def test_dryrun_one_device_bytes_are_the_states(cells_built):
    """At one device every byte of every tree is there."""
    with dryrun.fake_world(1):
        dmesh = dryrun.make_mesh("1")
        for cell, (_, _, trees, specs_for, _) in cells_built.items():
            got = dryrun.cell_bytes(trees, specs_for, dmesh)
            whole = {k: sum(t.numel() * t.element_size() for t in tree_leaves(v))
                     for k, v in trees.items()}
            assert {k: v for k, v in got.items() if k != "total"} == whole, cell


def test_run_cell_writes_artifacts(tmp_path):
    arts = dryrun.run_cell("mamba2_2p7b", "long_500k", meshes=["1", "16x16"],
                           out_dir=str(tmp_path))
    one, many = arts["1"], arts["16x16"]
    for art in (one, many):
        assert art["step_flops"] > 0 and art["step_bytes"] > 0
        assert 0 < art["roofline"]["roofline_fraction"] <= 1.0
        assert art["model_flops"] == 2 * art["active_params"] * 1
        assert (tmp_path / f"mamba2_2p7b__long_500k__{art['mesh']}.json").exists()
    assert one["roofline"]["dominant"] in ("compute_s", "memory_s")
    assert one["useful_flops_ratio"] == one["model_flops"] / one["step_flops"]
    # On the mesh the counts are one device's: the useful share is of all
    # 256 devices' FLOPs.
    assert many["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert many["useful_flops_ratio"] == many["model_flops"] / (256 * many["step_flops"])
    assert one["n_devices"] == 1 and one["collective"]["n"] == 0
    # The decode step runs on the fake world of 256: its collectives (the
    # weights gathered over 'data' at use, the activations' all-to-alls and
    # all-reduces over 'model') by 8-GPU node.
    assert many["n_devices"] == 256 and many["collective"]["n"] > 0
    assert many["collective"]["dcn"] + many["collective"]["ici"] > 0
    assert many["count_scope"] == "per device" and many["collectives"]
    assert "collective_note" not in many
    # The serving term is of tensor parallelism on weight shards: no weight
    # is gathered over a 'model' group (ranks 0-15 of rank 0's), so no
    # all-gather there carries more than an activation (mamba2's largest
    # weight is 2560 x 10576 bf16; one in_proj shard over 'model' is 1/16
    # of it), and no basis note qualifies the term.
    assert "collective_basis" not in many and "collective_basis" not in one
    model_group = [list(range(16))]
    over_model = [c for c in many["collectives"]
                  if c["op"] == "all-gather" and c["explicit_groups"] == model_group]
    assert all(c["result_bytes"] < 2560 * 10576 * 2 // 16 for c in over_model), over_model
    assert many["bytes_per_device"]["total"] < one["bytes_per_device"]["total"]
    assert one["fits_hbm80g"] == (one["bytes_per_device"]["total"] < mesh.HBM_BYTES)
    assert "N=not measured" not in roofline.summarize_artifact(many)
    skipped = dryrun.run_cell("stablelm_12b", "long_500k", meshes=["1"], out_dir=str(tmp_path))
    assert "sub-quadratic" in skipped["1"]["skipped"]
    assert "SKIP" in roofline.summarize_artifact(skipped["1"])


def test_decode_cell_charges_the_merge_of_a_sequence_split_cache():
    """stablelm-12b's decode_32k at 16 x 16: its 8 KV heads do not divide
    the 16-way 'model' axis, so its caches split their sequence and each
    layer's attention merges the ranks' partials over 'model': an
    all-reduce of the max log-sum-exp (B/16 x H f32) and one of the
    rescaled outputs beside their weights (B/16 x H x (hd + 1) f32), once
    a layer, among the 16 ranks of rank 0's 'model' group."""
    cfg = dryrun.production_config("stablelm_12b", "decode_32k")
    seq, batch, _ = SHAPES["decode_32k"]
    with dryrun.fake_world(256):
        dmesh = dryrun.make_mesh("16x16")
        step = dryrun.mesh_serving_count(
            cfg, dmesh, "decode", {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                                         device="meta")}, seq)
    b, H, hd = batch // 16, cfg.n_heads, cfg.head_dim
    model_group = [list(range(16))]
    merge = {(c["result_bytes"], c["count"]) for c in step.collectives
             if c["op"] == "all-reduce" and c["explicit_groups"] == model_group}
    assert {(b * H * 4, cfg.n_layers), (b * H * (hd + 1) * 4, cfg.n_layers)} <= merge, merge
    traffic = roofline.collective_traffic(step.collectives, n_devices=256,
                                          pod_size=mesh.NODE_SIZE)
    assert traffic["by_op"]["all-reduce"] > 0


def test_dryrun_all_writes_each_cell_and_mesh(tmp_path, monkeypatch, capsys):
    cells = [("mamba2_2p7b", "long_500k"), ("stablelm_12b", "long_500k")]
    monkeypatch.setattr(dryrun_all, "cells", lambda: cells)
    assert dryrun_all.main(["--out", str(tmp_path), "--mesh", "1", "--mesh", "2x16x16"]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{a}__{s}__{m}.json" for a, s in cells for m in ("1", "2x16x16"))
    assert dryrun_all.main(["--out", str(tmp_path), "--mesh", "1"]) == 0
    assert "0 cells to run" in capsys.readouterr().out  # artifacts kept


def test_production_mesh_needs_its_world():
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="256 ranks"):
            mesh.make_production_mesh(device_type="cpu")
    with dryrun.fake_world(256):
        m = mesh.make_production_mesh(device_type="cpu")
        assert (tuple(m.shape), m.mesh_dim_names) == ((16, 16), ("data", "model"))
        with pytest.raises(RuntimeError, match="512 ranks"):
            mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# FLOPs: count against hlo_analysis
# --------------------------------------------------------------------------
B, S = 2, 64


def _inputs(cfg):
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    jtokens = jnp.zeros((B, S), jnp.int32)
    if cfg.family != "encdec":
        return tokens, jtokens
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return ({"tokens": tokens,
             "enc_emb": torch.zeros((B, cfg.enc_len, cfg.d_model), dtype=dt, device="meta")},
            {"tokens": jtokens, "enc_emb": jnp.zeros((B, cfg.enc_len, cfg.d_model), cfg.dtype)})


def _hlo_flops(fn, *args) -> float:
    return hlo_analysis.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("arch", ["stablelm_12b", "grok_1_314b", "mamba2_2p7b",
                                  "zamba2_1p2b", "seamless_m4t_large_v2"])
def test_forward_flops_match_hlo_analysis(arch):
    cfg = get_smoke_config(arch)
    inputs, jinputs = _inputs(cfg)
    with torch.no_grad():
        got = trace_analysis.count(get_model(cfg).apply, inputs).flops
    jmodel = jax_get_model(jax_smoke_config(arch))
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    want = _hlo_flops(jmodel.apply, params, jinputs)
    if cfg.family == "hybrid":
        # The reference applies zamba2's shared attention+MLP block under
        # lax.cond inside the layer scan, and hlo_analysis weights no
        # conditional's branch computations (it follows while loops and
        # calls only), so the block's dots are not in its count.  The port
        # runs the block after every hybrid_period-th layer: it counts
        # n_layers // hybrid_period applications more, each the FLOPs that
        # hlo_analysis gives the JAX block alone.
        shared = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))["shared"]
        x = jax.ShapeDtypeStruct((B, S, cfg.d_model), cfg.dtype)
        block = _hlo_flops(lambda p, x: jmodel._attn_block_apply(p, x, is_local=False)[0],
                           shared, x)
        assert block > 0
        want += cfg.n_layers // cfg.hybrid_period * block
    assert got == want


def test_train_step_flops_match_hlo_analysis():
    """One smoke train step of the dense family.  Derived before the
    reading: both sides recompute each layer's forward in its backward
    (jax.checkpoint; torch.utils.checkpoint) and skip recomputing what the
    backward does not read; both differentiate the same dots.  They differ
    in the loss: the port's chunked_xent runs each chunk's (B, S/c, D) x
    (D, V) unembedding product under ``checkpointed`` and forms it again in
    the backward, while the reference's chunk scan keeps its residuals, so
    the port counts the unembedding's forward FLOPs, 2 B S D V, once more."""
    arch = "stablelm_12b"
    cfg = get_smoke_config(arch)
    state = init_state(cfg, OptConfig(), torch.Generator(), device="meta")
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    got = trace_analysis.count(make_train_step(cfg, OptConfig()), state,
                               {"tokens": tokens, "targets": tokens.clone()}).flops
    jcfg = jax_smoke_config(arch)
    jstate = jax.eval_shape(lambda: jax_init_state(jcfg, JaxOptConfig(), jax.random.PRNGKey(0)))
    jtokens = jnp.zeros((B, S), jnp.int32)
    want = _hlo_flops(jax_make_train_step(jcfg, JaxOptConfig()), jstate,
                      {"tokens": jtokens, "targets": jtokens})
    assert got == want + 2 * B * S * cfg.d_model * cfg.vocab


def test_count_bytes():
    """Every op's inputs and outputs, views and fresh buffers left out; an
    indexed in-place write counts what it touches."""
    a = torch.zeros((64, 32), device="meta")
    b = torch.zeros((32, 16), device="meta")

    def step(a, b):
        c = a.t().contiguous().t()  # a copy (two views and a clone)
        d = c @ b
        cache = torch.empty((8, 64, 16), device="meta")
        rows = torch.arange(8, device="meta")
        cache[rows, 3] = d[:8]
        return d[rows]

    c = trace_analysis.count(step, a, b)
    assert c.flops == 2 * 64 * 32 * 16
    want = (2 * 64 * 32 * 4  # clone: read a, write c
            + (64 * 32 + 32 * 16 + 64 * 16) * 4  # mm
            + 8 * 8  # arange writes 8 int64
            + 2 * (8 * 8 + 8 * 16 * 4)  # index_put_: indices and values, twice
            + 8 * 8 + 2 * 8 * 16 * 4)  # index: indices, and the rows read and written
    assert c.bytes == want, c.ops
    assert {n for n, _, _ in c.top_ops()} == {"aten.clone", "aten.mm", "aten.arange",
                                             "aten.index_put_", "aten.index"}


# --------------------------------------------------------------------------
# Roofline against the reference's
# --------------------------------------------------------------------------
COLLECTIVES = [
    {"op": "all-reduce", "result_bytes": 1024, "group_size": 4, "count": 2.0,
     "explicit_groups": None},
    {"op": "all-gather", "result_bytes": 4096, "group_size": 8, "count": 1.0,
     "explicit_groups": [[0, 1, 2, 3, 4, 5, 6, 7]]},
    {"op": "reduce-scatter", "result_bytes": 512, "group_size": 2, "count": 3.0,
     "explicit_groups": [[0, 256], [1, 257]]},
    {"op": "all-to-all", "result_bytes": 2048, "group_size": 16, "count": 1.0,
     "explicit_groups": None},
    {"op": "collective-permute", "result_bytes": 300, "group_size": 2, "count": 4.0,
     "explicit_groups": [[5, 9]]},
    {"op": "all-reduce", "result_bytes": 100, "group_size": 2, "count": 1.0,
     "explicit_groups": None},  # the pod axis at pod_size 256 of 512
    {"op": "all-gather", "result_bytes": 100, "group_size": 1, "count": 1.0,
     "explicit_groups": None},  # a group of one moves nothing
    {"op": "all-reduce", "result_bytes": 64, "group_size": 0, "count": 1.0,
     "explicit_groups": None},  # no group: all devices
]


@pytest.mark.parametrize("pod_size", [None, 8, 256])
def test_collective_traffic_matches(pod_size):
    for n in (256, 512):
        got = roofline.collective_traffic(COLLECTIVES, n_devices=n, pod_size=pod_size)
        want = jax_roofline.collective_traffic(COLLECTIVES, n_devices=n, pod_size=pod_size)
        assert got == want


def test_roofline_terms_match(monkeypatch):
    """The same arithmetic: with every constant set to the same values on
    both sides, the terms are equal."""
    for module in (roofline, jax_roofline):
        for name, value in [("PEAK_BF16_FLOPS", 7e12), ("HBM_BW", 3e11), ("ICI_BW", 5e10),
                            ("DCN_BW", 2e10)]:
            monkeypatch.setattr(module, name, value)
    traffic = roofline.collective_traffic(COLLECTIVES, n_devices=512, pod_size=256)
    for flops, nbytes in [(1e12, 1e9), (1e9, 1e12), (0.0, 0.0), (3e10, 1e6)]:
        kw = dict(flops_per_device=flops, bytes_per_device=nbytes, traffic=traffic)
        assert roofline.roofline_terms(**kw) == jax_roofline.roofline_terms(**kw)
    art = {"arch": "x", "shape": "train_4k", "mesh": "1", "n_devices": 1,
           "roofline": roofline.roofline_terms(**kw), "useful_flops_ratio": 0.5,
           "collective": traffic}
    assert roofline.summarize_artifact(art) == jax_roofline.summarize_artifact(art)


# Hand-made groups on 16 devices, two 8-GPU nodes (ranks 0-7 and 8-15).
NODE_GROUPS = [
    ("all-gather", 800, [[0, 1, 2, 3, 4, 5, 6, 7]], 800 * 7 / 8, 0.0),  # inside node 0
    ("reduce-scatter", 100, [[8, 9, 10, 11]], 0.0 + 100 * 3, 0.0),  # inside node 1
    ("all-reduce", 400, [[0, 8]], 0.0, 2 * 400 * 1 / 2),  # one GPU of each node
    ("all-to-all", 1600, [list(range(16))], 0.0, 1600 * 15 / 16),  # both nodes
    ("all-gather", 800, [[6, 7, 8, 9]], 0.0, 800 * 3 / 4),  # across the nodes' edge
]


@pytest.mark.parametrize("op,nbytes,groups,ici,dcn", NODE_GROUPS,
                         ids=[f"{c[0]}-{c[2][0][0]}-{len(c[2][0])}" for c in NODE_GROUPS])
def test_collective_traffic_by_node(op, nbytes, groups, ici, dcn):
    """With ``pod_size=NODE_SIZE`` a group inside one 8-GPU node is charged
    to NVLink (``ici``) and one that spans two nodes to InfiniBand (``dcn``),
    by the ring model's bytes; the reference's function agrees."""
    c = [dict(op=op, result_bytes=nbytes, group_size=len(groups[0]), count=1,
              explicit_groups=groups)]
    got = roofline.collective_traffic(c, n_devices=16, pod_size=mesh.NODE_SIZE)
    assert (got["ici"], got["dcn"], got["n"]) == (ici, dcn, 1)
    assert got == jax_roofline.collective_traffic(c, n_devices=16, pod_size=mesh.NODE_SIZE)
    assert mesh.NODE_SIZE == 8


def test_train_cell_on_a_mesh_has_a_collective_term(tmp_path):
    """mamba2's train_4k cell on 256 devices: the step run on the fake
    world gives one device's FLOPs and bytes and a numeric collective term
    charged by node; the 16-way 'model' axis spans two nodes, so every
    group of this mesh is charged to InfiniBand."""
    art = dryrun.run_cell("mamba2_2p7b", "train_4k", meshes=["16x16"],
                          out_dir=str(tmp_path))["16x16"]
    coll, roof = art["collective"], art["roofline"]
    assert art["count_scope"] == "per device" and art["n_devices"] == 256
    assert coll["n"] > 0 and coll["n"] == len(art["collectives"]) and roof["collective_s"] > 0
    assert coll["dcn"] > 0 and coll["ici"] == 0.0
    assert set(coll["by_op"]) >= {"all-gather", "reduce-scatter", "all-reduce"}
    assert all(len(c["explicit_groups"]) == 1 and c["group_size"] > 1 and c["count"] >= 1
               for c in art["collectives"])
    assert 0 < art["useful_flops_ratio"] <= 1.0
    assert art["useful_flops_ratio"] == art["model_flops"] / (art["step_flops"] * 256)
    assert roof["compute_s"] == art["step_flops"] / mesh.PEAK_BF16_FLOPS
    assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert "N=not measured" not in roofline.summarize_artifact(art)
    assert (tmp_path / "mamba2_2p7b__train_4k__16x16.json").exists()


def test_h100_constants():
    assert (mesh.PEAK_BF16_FLOPS, mesh.HBM_BW, mesh.ICI_BW, mesh.DCN_BW, mesh.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 50e9, 80e9)
    assert mesh.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


# --------------------------------------------------------------------------
# Profiles
# --------------------------------------------------------------------------
def _event(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_read_profile_on_a_synthetic_trace():
    prefill = "void flash_prefill_wgmma_kernel<160, 1>(PrefillArgs, Packing, TileMaps)"
    events = [_event("aten::mm", 0.0, 1000.0, DeviceType.CPU)]
    events += [_event(prefill, 100.0 + 10 * i, 105.0 + 10 * i) for i in range(40)]
    events += [_event("flash_prefill_wgmma_kernel_tail", 600.0, 610.0)]
    events += [_event("void flash_decode_bf16_kernel<160>(DecodeArgs)", 700.0, 720.0),
               _event("gemv", 710.0, 730.0)]  # overlaps the decode kernel by 10 us
    reading = trace_analysis.read_profile(SimpleNamespace(events=lambda: events))
    assert reading.kernels[prefill].launches == 40
    assert reading.kernels[prefill].device_ms == pytest.approx(40 * 5 / 1e3)
    assert reading.launches_of("flash_prefill_wgmma_kernel") == 40  # not the _tail kernel
    assert reading.launches_of("flash_decode_bf16_kernel") == 1
    assert reading.window_ms == pytest.approx(1.0)
    assert reading.busy_ms == pytest.approx((200 + 10 + 30) / 1e3)
    assert reading.busy_share + reading.idle_share == pytest.approx(1.0)
    assert reading.top(1)[0][0] == prefill
    assert trace_analysis.check_launches(reading, {"flash_prefill_wgmma_kernel": 40,
                                                   "ssd_intra_chunk_bf16_kernel": 0})
    with pytest.raises(AssertionError, match="device-side launches"):
        trace_analysis.check_launches(reading, {"flash_decode_bf16_kernel": 2})
    timed = trace_analysis.read_profile(SimpleNamespace(events=lambda: events), wall_ms=2.0)
    assert timed.busy_share == pytest.approx(0.24 / 2.0)


@pytest.mark.parametrize("expected,missing_ok,passes", [
    ({"flash_prefill_wgmma_kernel": 41}, {"flash_prefill_wgmma_kernel": 1}, True),
    ({"flash_prefill_wgmma_kernel": 42}, {"flash_prefill_wgmma_kernel": 1}, False),
    ({"flash_prefill_wgmma_kernel": 41}, {"flash_decode_bf16_kernel": 1}, False),
    ({"flash_decode_bf16_kernel": 2}, {"flash_prefill_wgmma_kernel": 1}, False),
    ({"ssd_intra_chunk_bf16_kernel": 1}, {"ssd_intra_chunk_bf16_kernel": 1}, False),
    ({"ssd_intra_chunk_bf16_kernel": 0}, {"ssd_intra_chunk_bf16_kernel": 1}, True)])
def test_check_launches_allows_only_the_named_shortfall(expected, missing_ok, passes):
    """``check_launches`` with ``missing_ok``: a named kernel may show at
    most that many launches fewer than expected, never more and never none
    where any was expected; every other kernel is held exactly."""
    events = [_event("void flash_prefill_wgmma_kernel<160, 1>(PrefillArgs)", 10.0 * i,
                     10.0 * i + 5) for i in range(40)]
    events += [_event("void flash_decode_bf16_kernel<160>(DecodeArgs)", 500.0, 510.0)]
    reading = trace_analysis.read_profile(SimpleNamespace(events=lambda: events))
    if passes:
        got = trace_analysis.check_launches(reading, expected, missing_ok)
        assert got == {s: reading.launches_of(s) for s in expected}
    else:
        with pytest.raises(AssertionError, match="at most"):
            trace_analysis.check_launches(reading, expected, missing_ok)


def test_read_profile_on_a_cpu_decode_step():
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    state = model.decode_init(2, 16)
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.decode_step(state, tokens)
    reading = trace_analysis.read_profile(prof)
    assert reading.kernels == {} and reading.busy_ms == 0.0
    assert reading.window_ms > 0 and reading.idle_share == 1.0
    assert trace_analysis.check_launches(reading, {"flash_decode_bf16_kernel": 0}) == {
        "flash_decode_bf16_kernel": 0}
    with pytest.raises(AssertionError):
        trace_analysis.check_launches(reading, {"flash_decode_bf16_kernel": cfg.n_layers})


# --------------------------------------------------------------------------
# Isolation
# --------------------------------------------------------------------------
_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import torch.testing._internal.distributed.fake_pg
from repro_torch.launch import dryrun
with dryrun.fake_world(4):
    pass
print("WALKED", sorted(n for n in names if n.startswith("repro_torch.launch.")))
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "ml_dtypes", "repro") or n.startswith(("jax.", "repro.")))
print("LEAKED", bad)
"""


def test_launch_modules_import_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    walked = sorted(f"repro_torch.launch.{m}" for m in ("dryrun", "dryrun_all", "mesh",
                                                         "roofline", "serve", "train",
                                                         "trace_analysis"))
    assert f"WALKED {walked}" in out.stdout, out.stdout


# --------------------------------------------------------------------------
# The router's sealed-batch relay (the codec copy)
# --------------------------------------------------------------------------
def _router_run(package):
    core = importlib.import_module(package)
    spec = core.ClusterSpec(
        f=1, n_clients=4, sm_factory=core.KVStoreSM,
        options=core.Options(batch_max=4, batch_flush_interval=2e-3), num_shards=2,
        route_via_router=True, client_coalesce=True)
    sim, dep = spec.deploy(seed=0)
    dep.start_clients()
    sim.run_for(0.2)
    dep.check_all()
    return dict(completed=sum(len(c.latencies) for c in dep.clients),
                latencies=[c.latencies for c in dep.clients],
                messages_sent=sim.messages_sent, now=sim.now)


def test_sealed_batch_router_runs_as_the_reference():
    got, want = _router_run("repro_torch.core"), _router_run("repro.core")
    assert want["completed"] > 0
    assert got == want
