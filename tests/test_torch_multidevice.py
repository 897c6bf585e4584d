"""The port's mesh path on 8 gloo ranks on the CPU, against the JAX package.

The ranks are ``tests/multidevice_ranks.py``'s (spawned processes joined
through a ``FileStore``, one thread each, importing only ``repro_torch``),
launched once for all the cases by a module-scoped fixture that writes the
inputs (numpy, from seeds) and reads every case's result; each case stays
its own test.  The JAX side runs here, in the test's own process.  The f32 smoke configs;
each tolerance stands beside its constant.

(a) ``constrain_residual``, ``constrain_attn_qkv`` and
    ``constrain_seq_sharded`` on a (2, 2, 2) (pod, data, model) mesh: the
    values equal the input bit for bit and the placements are
    ``to_placements`` of the spec the reference's own function asks for
    (read by standing in for its ``_constrain``), for both policies, for
    shapes that do not divide, and for the SSM family's early return.
(b) ``attention_fsdp_seqshard``: the whole output equals JAX's
    ``attention_chunked`` on the same inputs, causal and windowed (gemma2,
    ``is_local``), and at ``Sq % model != 0``, where it falls back.
(c) stablelm's smoke forward under fsdp and under tp: the logits equal
    JAX's one-device ``apply``.
(d) one ``make_train_step`` with ``grad_specs`` under fsdp, and one with
    ``microbatches=2``: loss, grad norm and updated masters against JAX's
    one-device step; and ``global_norm`` of a tree that mixes shards and
    replicas, each element counted once.
(e) ``ElasticTrainer`` at 2 pods x 2 ranks, scaled to 4 x 2 and to 1 x 2
    (the counterpart of tests/coord/test_elastic_multidevice.py): the mesh
    shapes, falling losses, no stall, the ledger's safety, and the losses
    of the one-process port trainer.
(f) a checkpoint saved from the (4, 2) mesh restores on (1, 2), and into
    the JAX package, bit for bit.
(g) the port's ``attention`` under ``sharding_policy="fsdp"`` takes
    ``attention_chunked``, as the reference (no ranks).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multidevice_ranks as ranks
from repro import train as jtrain
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.models import sharding as jsharding
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.coord import ElasticConfig, ElasticTrainer
from repro_torch.models import layers
from repro_torch.train import OptConfig, init_state
from repro_torch.train.data import DataConfig, TokenPipeline
from repro_torch.weights import flatten, train_state_to_jax
from test_torch_chip_smoke import smoke

SIZES = dict(zip(("pod", "data", "model"), ranks.MESH_SHAPE))
RANKS = int(np.prod(ranks.MESH_SHAPE))
# (b) Both sides run the same chunked attention in f32 on O(1) values; they
# differ in the order of the f32 sums of each einsum (~1e-7).
ATTENTION_ATOL = 1e-6
# (c) The same f32 forward summed in other orders on both sides, through
# two layers: held at 1e-5 of the largest |logit|.
LOGITS_RTOL = 1e-5
# (d) The loss is the f32 forward's, as (c).  The gradient of a weight that
# each rank gathers at use comes back to its layout reduced in f32 (the
# gather's backward), then is rounded to bf16 once, as JAX's one-device
# gradient: the two differ where f32 reassociation moves an element across
# a bf16 rounding boundary, the case of the one-device parity constants
# (chip_smoke.py's gate (a), reasons beside them).  A replicated
# parameter's gradient (the norm scales) reaches the pin as a partial sum
# on each of the R ranks, is rounded to bf16 there and summed in bf16: R
# roundings of the partials and R - 1 of the running sum, each at most
# 2^-9 of a term no larger than A = sum_r |g_r|, beside JAX's own rounding,
# so each element is off by at most (R + 1) 2^-9 A, and with two
# microbatches (their bf16 sum one more rounding) (R + 2) 2^-9 A.  The
# grad norm is held at the one-device tolerance plus that bound's L2 norm
# (A read on the ranks).  Adam's first step moves each master by lr x
# g / (|g| + eps) + lr wd p: at most 2 lr apart whatever the gradients, so
# every master within 2 lr; among the gathered weights at most one element
# in a thousand more than lr / 16 apart, as on one device.
LOSS_RTOL = 1e-5
BF16_HALF_STEP = 2.0 ** -9
TRAIN_LR = smoke.PARITY_LR
# (e) Data parallelism sums the same f32 terms in other orders each step;
# over 18 steps, held at 1e-5 relative.
ELASTIC_LOSS_RTOL = 1e-5

# The global norm: f32 squares summed in another order than numpy's f64
# sum, over ~2e4 elements: 1e-6 relative.  A replicated tensor counted once
# a rank would read sqrt(8) of its share.
NORM_RTOL = 1e-6
NORM_LAYOUTS = {"sharded": ["S0", "S0", "S0"], "replicated": ["R", "R", "R"],
                "mixed": ["S1", "R", "S0"]}

TRAIN_B, TRAIN_S = 8, 32
ELASTIC = dict(
    arch="stablelm_12b", steps=6, save_on=[4, 2],
    schedule=[["pod0", "pod1"], ["pod0", "pod1", "pod2", "pod3"], ["pod0"]],
    opt=dict(lr=3e-3, warmup_steps=5, total_steps=200),
    data=dict(seq_len=32, global_batch=8, seed=0),
    ecfg=dict(checkpoint_every=100, commit_every=4, devices_per_pod=2))


def _entries(spec, rank):
    """A JAX PartitionSpec as JSON entries padded to ``rank``."""
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]
    return out + [None] * (rank - len(out))


def reference_specs(monkeypatch, fn, *xs):
    """The specs the reference's constraint asks for on a (2, 2, 2) mesh:
    its ``_mesh_sizes`` and ``_constrain`` stood in for, so its own rules
    decide.  None for each input where it constrains nothing."""
    seen = []
    monkeypatch.setattr(jsharding, "_mesh_sizes", lambda: dict(SIZES))
    monkeypatch.setattr(jsharding, "_constrain", lambda x, spec: seen.append(spec) or x)
    fn(*(jnp.zeros(x.shape, jnp.float32) for x in xs))
    monkeypatch.undo()
    return [_entries(s, x.ndim) for s, x in zip(seen, xs)] if seen else [None] * len(xs)


def constrain_cases(monkeypatch, rng, arrays):
    shapes = {"residual": [[(4, 32, 64)], [(3, 31, 64)]],
              "seq_sharded": [[(4, 32, 64)], [(3, 31, 64)]],
              "attn_qkv": [[(4, 32, 4, 16), (4, 32, 2, 16), (4, 32, 2, 16)],
                           [(3, 31, 3, 16), (3, 31, 1, 16), (3, 31, 1, 16)]]}
    cases = []
    for arch, policies in (("stablelm_12b", ("tp", "fsdp")), ("mamba2_2p7b", ("fsdp",))):
        for policy in policies:
            jcfg = jax_smoke_config(arch).replace(sharding_policy=policy)
            fns = {"residual": lambda x: jsharding.constrain_residual(jcfg, x),
                   "seq_sharded": jsharding.constrain_seq_sharded,
                   "attn_qkv": lambda *qkv: jsharding.constrain_attn_qkv(jcfg, *qkv)}
            for fn, variants in shapes.items():
                if arch != "stablelm_12b" and fn != "attn_qkv":
                    continue
                for n, variant in enumerate(variants):
                    name = f"{arch}/{policy}/{fn}/{'divides' if n == 0 else 'does-not'}"
                    xs = [rng.standard_normal(s).astype(np.float32) for s in variant]
                    for i, x in enumerate(xs):
                        arrays[f"constrain/{name}/{i}"] = x
                    cases.append(dict(name=name, arch=arch, policy=policy, fn=fn,
                                      want=reference_specs(monkeypatch, fns[fn], *xs)))
    return cases


ATTENTION = [dict(name="causal", arch="stablelm_12b", S=32, is_local=False),
             dict(name="window", arch="gemma2_2b", S=32, is_local=True),
             dict(name="fallback", arch="stablelm_12b", S=31, is_local=False)]


def attention_cases(rng, arrays):
    for case in ATTENTION:
        cfg = get_smoke_config(case["arch"])
        for n, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
            arrays[f"attention/{case['name']}/{n}"] = rng.standard_normal(
                (4, case["S"], heads, cfg.head_dim)).astype(np.float32)
    return ATTENTION


def jax_params(arch="stablelm_12b"):
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    return jcfg, jax.tree.map(np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(0)))


def train_inputs(arrays):
    """The port's initial smoke state (as JAX's tree, flat) and one batch."""
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    state = init_state(cfg, OptConfig(lr=TRAIN_LR, warmup_steps=1),
                       torch.Generator().manual_seed(0), device="cpu")
    tree = train_state_to_jax(state)
    flat = {**{f"params.{k}": v for k, v in flatten(tree.params).items()},
            **{f"opt.m.{k}": v for k, v in flatten(tree.opt.m).items()},
            **{f"opt.v.{k}": v for k, v in flatten(tree.opt.v).items()},
            "opt.step": tree.opt.step, "step": tree.step}
    arrays.update({f"train/state/{k}": np.asarray(v) for k, v in flat.items()})
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                     global_batch=TRAIN_B)).batch_at(0)
    arrays.update({f"train/{k}": v for k, v in batch.items()})
    return tree, batch


def write_inputs(tmp, arrays, spec):
    np.savez(os.path.join(tmp, "in.npz"), **arrays)
    with open(os.path.join(tmp, "in.json"), "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One launch of the 8 ranks for every case, (a) to (f); the inputs and
    the JAX side's data."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(0)
    arrays = {}
    mp = pytest.MonkeyPatch()
    spec = dict(constrain=constrain_cases(mp, rng, arrays), attention=attention_cases(rng, arrays))
    for name in NORM_LAYOUTS:
        arrays[f"norm/{name}"] = rng.standard_normal((16, 8, 64)).astype(np.float32)
    spec["norm"] = NORM_LAYOUTS
    jcfg, params = jax_params()
    arrays.update({f"forward/params/{k}": v for k, v in flatten(params).items()})
    arrays["forward/tokens"] = rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32)
    spec["forward"] = dict(arch="stablelm_12b", policies=["fsdp", "tp"])
    tree, batch = train_inputs(arrays)
    spec["train"] = dict(arch="stablelm_12b", opt=dict(lr=TRAIN_LR, warmup_steps=1),
                         microbatches=[1, 2], batch_keys=sorted(batch))
    spec["elastic"] = ELASTIC
    write_inputs(tmp, arrays, spec)
    out_arrays, out, seconds = ranks.launch("all", tmp)
    return dict(arrays=arrays, spec=spec, out=out, out_arrays=out_arrays, params=params,
                jcfg=jcfg, tree=tree, batch=batch, seconds=seconds, tmp=tmp)


def test_constraints_match_the_reference(mesh_run):
    """(a) Bit-equal values; the placements of the reference's specs."""
    for case in mesh_run["spec"]["constrain"]:
        rows = mesh_run["out"]["constrain"][case["name"]]
        assert len(rows) == len(case["want"]), case["name"]
        for row in rows:
            assert row["equal"], case["name"]
            assert row["got"] == row["want"], (case["name"], row)
    names = {c["name"]: c for c in mesh_run["spec"]["constrain"]}
    # The cases the rules fall back in, and the SSM early return, are here.
    assert names["mamba2_2p7b/fsdp/attn_qkv/divides"]["want"] == [None] * 3
    assert names["stablelm_12b/fsdp/residual/does-not"]["want"] == [[None, None, None]]


@pytest.mark.parametrize("case", ATTENTION, ids=[c["name"] for c in ATTENTION])
def test_attention_fsdp_seqshard(mesh_run, case):
    """(b) The whole output against JAX's attention_chunked; the route by
    the output's layout (queries split over 'model', or gathered)."""
    arrays = mesh_run["arrays"]
    q, k, v = (arrays[f"attention/{case['name']}/{n}"] for n in "qkv")
    jcfg = jax_smoke_config(case["arch"]).replace(dtype="float32", sharding_policy="fsdp")
    want = jlayers.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=jcfg,
                                     causal=True, is_local=case["is_local"])
    got = mesh_run["out_arrays"][f"attention/{case['name']}"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATTENTION_ATOL)
    layout = mesh_run["out"]["attention"][case["name"]]["out"]
    if case["name"] == "fallback":
        assert layout[2] == "Replicate()", layout
    else:
        assert layout == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"], layout


@pytest.mark.parametrize("policy", ["fsdp", "tp"])
def test_forward_matches_jax(mesh_run, policy):
    """(c) The smoke logits on 8 ranks against JAX's one-device apply."""
    jcfg = mesh_run["jcfg"].replace(sharding_policy=policy)
    want = np.asarray(jax_get_model(jcfg).apply(
        jax.tree.map(jnp.asarray, mesh_run["params"]),
        jnp.asarray(mesh_run["arrays"]["forward/tokens"])))
    got = mesh_run["out_arrays"][f"forward/{policy}"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max()


def test_global_norm_counts_a_replica_once(mesh_run):
    """(d) ``global_norm`` over shards and replicas on the 8 ranks against
    the norm of the whole tensors."""
    want = np.sqrt(sum(np.sum(mesh_run["arrays"][f"norm/{name}"].astype(np.float64) ** 2)
                       for name in NORM_LAYOUTS))
    np.testing.assert_allclose(mesh_run["out"]["norm"], want, rtol=NORM_RTOL)


def jax_step(tree, batch, microbatches):
    jcfg = jax_smoke_config("stablelm_12b").replace(dtype="float32", sharding_policy="fsdp")
    jstate = jtrain.TrainState(
        params=jax.tree.map(jnp.asarray, tree.params),
        opt=jopt.AdamState(m=jax.tree.map(jnp.asarray, tree.opt.m),
                           v=jax.tree.map(jnp.asarray, tree.opt.v),
                           step=jnp.asarray(tree.opt.step)),
        step=jnp.asarray(tree.step))
    step = jtrain.make_train_step(jcfg, jtrain.OptConfig(lr=TRAIN_LR, warmup_steps=1),
                                  microbatches=microbatches)
    new, metrics = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return flatten(jax.tree.map(np.asarray, new.params)), metrics


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_with_grad_specs(mesh_run, microbatches):
    """(d) Loss, grad norm and updated masters against JAX's one-device step."""
    want, metrics = jax_step(mesh_run["tree"], mesh_run["batch"], microbatches)
    row = mesh_run["out"]["train"][str(microbatches)]
    np.testing.assert_allclose(row["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    extra = RANKS + (1 if microbatches == 1 else 2)
    tol = (smoke.PARITY_METRIC_RTOL * float(metrics["grad_norm"])
           + extra * BF16_HALF_STEP * row["abs_partial_norm"])
    assert abs(row["grad_norm"] - float(metrics["grad_norm"])) <= tol, (row, metrics)
    far = total = 0
    for name, w in want.items():
        d = np.abs(mesh_run["out_arrays"][f"train/{microbatches}/{name}"] - w)
        assert d.max() <= 2 * TRAIN_LR, name
        if name not in row["partial"]:
            far += int((d > smoke.PARITY_PARAM_FAR).sum())
            total += d.size
    assert far <= smoke.PARITY_PARAM_SHARE * total, (far, total)


def one_process_losses(tmp_path):
    cfg = get_smoke_config(ELASTIC["arch"]).replace(dtype="float32")
    tr = ElasticTrainer(cfg, OptConfig(**ELASTIC["opt"]),
                        DataConfig(vocab=cfg.vocab, **ELASTIC["data"]),
                        pods=ELASTIC["schedule"][0], device="cpu",
                        ecfg=ElasticConfig(checkpoint_dir=str(tmp_path), **ELASTIC["ecfg"]))
    for i, pods in enumerate(ELASTIC["schedule"]):
        if i:
            tr.scale_to(pods)
        tr.run(ELASTIC["steps"])
    return tr.losses, [e for e in tr.events if e["t"] == "remesh"]


def test_elastic_on_8_ranks(mesh_run, tmp_path):
    """(e) 2 -> 4 -> 1 pods of 2 ranks: shapes, losses, stalls, safety."""
    out = mesh_run["out"]["elastic"]
    shapes = [tuple(s) for s in out["shapes"]]
    assert sorted(set(shapes), key=shapes.index) == [(2, 2), (4, 2), (1, 2)], shapes
    assert [e["devices"] for e in out["events"]] == [4, 8, 2]
    losses = np.array(out["losses"])
    assert len(losses) == 3 * ELASTIC["steps"] and np.isfinite(losses).all()
    assert losses[-3:].mean() < losses[:3].mean()
    assert out["stall_count"] == 0 and out["safe"]
    want, events = one_process_losses(tmp_path)
    np.testing.assert_allclose(losses, want, rtol=ELASTIC_LOSS_RTOL)
    assert [(e["step"], e["pods"]) for e in out["events"]] == [
        (e["step"], e["pods"]) for e in events]


def test_checkpoint_moves_between_meshes_and_packages(mesh_run):
    """(f) Saved from (4, 2), restored on (1, 2) and saved again: the same
    files; restored by the JAX package: the same arrays."""
    out, tmp = mesh_run["out"]["elastic"], mesh_run["tmp"]
    saved, resaved = out["saved"], out["resaved"]
    assert out["restored_mesh"] == [1, 2]
    assert saved["entries"] == resaved["entries"] and saved["files"] == resaved["files"]
    first = os.path.join(tmp, "from_4x2")
    with np.load(os.path.join(first, saved["files"]["0"]["path"])) as z, \
            np.load(os.path.join(tmp, "restored_on_1x2", resaved["files"]["0"]["path"])) as r:
        for e in saved["entries"]:
            assert np.array_equal(z[e["key"]], r[e["key"]]), e["name"]
        jcfg = jax_smoke_config(ELASTIC["arch"]).replace(dtype="float32")
        like = jtrain.init_state(jcfg, jtrain.OptConfig(**ELASTIC["opt"]), jax.random.PRNGKey(1))
        restored = jcheckpoint.restore(first, saved, like)
        leaves = jax.tree.leaves(restored)
        assert len(leaves) == len(saved["entries"])
        for leaf, e in zip(leaves, saved["entries"]):
            assert np.array_equal(np.asarray(leaf), z[e["key"]]), e["name"]


def test_fsdp_attention_takes_chunked(monkeypatch):
    """(g) With no mesh, the fsdp policy's attention is attention_chunked
    in both packages (stablelm's smoke config at Sq = 2 x attn_q_chunk,
    where ``auto`` would take the naive one), and the outputs agree."""
    jcfg = jax_smoke_config("stablelm_12b").replace(dtype="float32", sharding_policy="fsdp")
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32", sharding_policy="fsdp")
    S = 2 * cfg.attn_q_chunk
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, S, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    routes = []
    for name in ("attention_chunked", "attention_naive"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *a, _fn=fn, _name=name, **kw: routes.append(_name) or _fn(*a, **kw))
    got = layers.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg=cfg)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=jcfg)
    assert routes == ["attention_chunked"], routes
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATTENTION_ATOL)
