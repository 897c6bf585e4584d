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

A second launch of the ranks, for the families on a mesh, while JAX's
steps and the dry-run's counts run here:

(h) the MoE's pins: their placements are ``to_placements`` of the specs
    the reference's ``pin`` asks for (its ``_constrain`` stood in for),
    under expert parallelism on (2, 2, 2) and TP-within-expert on
    (1, 1, 8); the output and aux metrics JAX's.
(i) the tp train step of grok and scout (both meshes), mamba2 and
    zamba2, and seamless's fsdp step, against JAX's one-device step.
(j) scout with int8 moments: the q/s gathered equal JAX's update of the
    mesh's gradients; an update laid out by hand (a last dim split at
    whole blocks, one split inside a block) against JAX's.
(k) each family's collectives on the ranks equal, record for record,
    those the dry-run counts on a fake world of 8 on meta.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

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


# ---------------------------------------------------------------------------
# The families on a mesh: one more launch of the 8 ranks, cases (h) to (k)
# ---------------------------------------------------------------------------
MESHES = {"222": [2, 2, 2], "118": [1, 1, 8]}
# (h) The MoE's pins, scout's smoke config (4 experts): on (2, 2, 2) the
# experts divide 'model' (expert parallelism), on (1, 1, 8) they do not
# and the expert FFN width (128) rides it (TP-within-expert).
PINS = [dict(name=f"{arch}/{m}", arch=arch, mesh=MESHES[m])
        for arch in ("llama4_scout_17b_a16e",) for m in MESHES]
# The MoE output: the same f32 products, a TP-within-expert product's sum
# over F split across the ranks and added in another order: ~1e-7 of the
# largest |y|, held at 1e-5 of it as the logits of (c); the aux metrics are
# means of the same f32 values over the groups: 1e-6 relative.
MOE_Y_RTOL, MOE_AUX_RTOL = 1e-5, 1e-6
# (i) Each family's smoke step under its training policy (policy_for):
# grok and scout on both meshes, mamba2 and zamba2 (tp) and seamless (fsdp)
# on (2, 2, 2), scout with int8 moments on (2, 2, 2).
FAMILY_STEPS = [
    dict(name="grok/222", arch="grok_1_314b", mesh=MESHES["222"]),
    dict(name="grok/118", arch="grok_1_314b", mesh=MESHES["118"]),
    dict(name="scout/222", arch="llama4_scout_17b_a16e", mesh=MESHES["222"]),
    dict(name="scout/118", arch="llama4_scout_17b_a16e", mesh=MESHES["118"]),
    dict(name="mamba2/222", arch="mamba2_2p7b", mesh=MESHES["222"]),
    dict(name="zamba2/222", arch="zamba2_1p2b", mesh=MESHES["222"]),
    dict(name="seamless/222", arch="seamless_m4t_large_v2", mesh=MESHES["222"]),
    dict(name="scout-int8/222", arch="llama4_scout_17b_a16e", mesh=MESHES["222"], int8=True),
]
# (k) The steps whose collectives are held against the dry-run's (their
# gradients are read too): one a family, on (2, 2, 2).
COLLECTIVE_STEPS = [c for c in FAMILY_STEPS if c["mesh"] == MESHES["222"]]
FAMILY_B, FAMILY_S = 8, 32
JAX_THREADS = 3
# (j) The q/s of the int8 step on the mesh against JAX's update of the same
# (the mesh's) bf16 gradients from the same state: the same f32 arithmetic
# element by element but for the clip scale, from a global norm summed in
# another order (~1e-7 relative).  q = round(m / s) with s = max|m| / 127
# over a block is invariant to that scale but for rounding, so an element
# within ~1e-7 of a half step moves q by one: at most one in a thousand,
# by one; s within 1e-6 relative.  A master moves by lr x mh / (sqrt(vh) +
# eps) + lr wd p, the same f32 operations on both sides but for the scale
# and the order XLA fuses them in: a few ulps of the result, 1e-6 relative
# (with 1e-6 absolute near zero).  Where an element's v is below 1/254 of
# its block's largest, its int8 level is 0 and the master jumps by up to
# lr x m / eps (to ~20 here): relative it stays.
Q8_SHARE, SCALE_RTOL, MASTER_RTOL, MASTER_ATOL = 1e-3, 1e-6, 1e-6, 1e-6
# The hand-laid-out update: (name, shape, spec of the master, spec of q/s
# as state_specs lays it out).  "whole_blocks" splits its last dim (1024,
# four blocks of 256) over 'model' at a block's edge; "inside_block" splits
# 1000 (four blocks, the last padded) at 500, inside a block, so it is
# gathered before it is quantised; "lead" splits a lead dim; "vector" is
# replicated.
INT8_TREE = [("whole_blocks", (8, 1024), (None, "model"), (None, "model", None)),
             ("inside_block", (8, 1000), (None, "model"), (None, "model", None)),
             ("lead", (16, 300), (("pod", "data"), None), (("pod", "data"), None, None)),
             ("vector", (6,), (None,), (None, None))]
INT8_OPT = dict(lr=1e-2, warmup_steps=1, int8_state=True)


def family_cfg(arch, **kw):
    from repro_torch.models.sharding import policy_for

    cfg = get_smoke_config(arch).replace(dtype="float32", **kw)
    return cfg.replace(sharding_policy=policy_for(cfg, "train"))


def family_inputs(arrays):
    """Each family's initial state (the port's, seed 0, as JAX's tree) and
    batch, by state name; and the step cases for the ranks."""
    inputs, cases = {}, []
    for case in FAMILY_STEPS:
        state = case["name"].split("/")[0]
        cfg = family_cfg(case["arch"])
        opt = dict(lr=TRAIN_LR, warmup_steps=1, int8_state=case.get("int8", False))
        if state not in inputs:
            tree = train_state_to_jax(init_state(cfg, OptConfig(**opt),
                                                 torch.Generator().manual_seed(0), device="cpu"))
            flat = {**{f"params.{k}": v for k, v in flatten(tree.params).items()},
                    **{f"opt.m.{k}": v for k, v in flatten(tree.opt.m).items()},
                    **{f"opt.v.{k}": v for k, v in flatten(tree.opt.v).items()},
                    "opt.step": tree.opt.step, "step": tree.step}
            arrays.update({f"steps/{state}/state/{k}": np.asarray(v) for k, v in flat.items()})
            batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=FAMILY_S,
                                             global_batch=FAMILY_B)).batch_at(0)
            if cfg.family == "encdec":
                batch["enc_emb"] = np.random.default_rng(1).standard_normal(
                    (FAMILY_B, cfg.enc_len, cfg.d_model)).astype(np.float32)
            arrays.update({f"steps/{state}/batch/{k}": v for k, v in batch.items()})
            inputs[state] = dict(tree=tree, batch=batch, opt=opt, cfg=cfg)
        cases.append(dict(case, state=state, policy=cfg.sharding_policy, opt=opt,
                          batch_keys=sorted(inputs[state]["batch"]),
                          record=case in COLLECTIVE_STEPS))
    return inputs, cases


def pin_inputs(monkeypatch, rng, arrays):
    """The MoE weights and x of each pin case, and the specs the
    reference's ``pin`` asks for on its mesh."""
    from repro.models import moe as jmoe

    cases = []
    for case in PINS:
        jcfg = jax_smoke_config(case["arch"]).replace(dtype="float32", sharding_policy="tp")
        jp = jax.tree.map(np.asarray, jmoe.moe_init(jcfg, jax.random.PRNGKey(3), jnp.float32))
        x = rng.standard_normal((FAMILY_B, FAMILY_S, jcfg.d_model)).astype(np.float32)
        arrays.update({f"pins/{case['name']}/p/{k}": v for k, v in flatten(jp).items()})
        arrays[f"pins/{case['name']}/x"] = x
        seen = []
        sizes = dict(zip(("pod", "data", "model"), case["mesh"]))
        monkeypatch.setattr(jsharding, "_mesh_sizes", lambda: dict(sizes))
        monkeypatch.setattr(jsharding, "_constrain", lambda t, spec: seen.append((spec, t)) or t)
        y, aux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
        monkeypatch.undo()
        cases.append(dict(case, want=[_entries(sp, t.ndim) for sp, t in seen],
                          y=np.asarray(y), aux={k: float(v) for k, v in aux.items()}))
    return cases


def int8_inputs(rng, arrays):
    """The hand-laid-out int8 update's masters, bf16-exact gradients (norm
    below the clip, so the clip scale is 1 on both sides) and a state one
    step in."""
    spec = dict(params={}, q={}, step=1, opt=INT8_OPT)
    state = {"m": {}, "v": {}}
    for name, shape, pspec, qspec in INT8_TREE:
        p = rng.standard_normal(shape).astype(np.float32) * 0.1
        g = np.asarray(jnp.asarray(rng.standard_normal(shape) * 1e-3, jnp.bfloat16)
                       .astype(jnp.float32))
        arrays[f"int8/p/{name}"], arrays[f"int8/g/{name}"] = p, g
        for which, x in (("m", rng.standard_normal(shape) * 1e-3),
                         ("v", rng.standard_normal(shape) ** 2 * 1e-6)):
            q, s = jopt._q8(jnp.asarray(x, jnp.float32), 256)
            state[which][name] = {"q": np.asarray(q), "s": np.asarray(s)}
            arrays[f"int8/{which}/q/{name}"] = np.asarray(q)
            arrays[f"int8/{which}/s/{name}"] = np.asarray(s)
        spec["params"][name] = list(pspec)
        spec["q"][name] = list(qspec)
    return spec, state


def jax_family_step(inputs, microbatches=1):
    """JAX's one-device step of a family's smoke config from its state."""
    cfg, tree = inputs["cfg"], inputs["tree"]
    jcfg = jax_smoke_config(cfg.arch_id).replace(dtype="float32",
                                                 sharding_policy=cfg.sharding_policy)
    jstate = jtrain.TrainState(
        params=jax.tree.map(jnp.asarray, tree.params),
        opt=jopt.AdamState(m=jax.tree.map(jnp.asarray, tree.opt.m),
                           v=jax.tree.map(jnp.asarray, tree.opt.v),
                           step=jnp.asarray(tree.opt.step)),
        step=jnp.asarray(tree.step))
    step = jtrain.make_train_step(jcfg, jtrain.OptConfig(**inputs["opt"]),
                                  microbatches=microbatches)
    new, metrics = step(jstate, {k: jnp.asarray(v) for k, v in inputs["batch"].items()})
    return dict(params=flatten(jax.tree.map(np.asarray, new.params)),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def families_run(tmp_path_factory):
    """One launch of the 8 ranks for cases (h) to (k); the JAX side runs
    here while they do."""
    tmp = str(tmp_path_factory.mktemp("families"))
    rng = np.random.default_rng(7)
    arrays = {}
    mp = pytest.MonkeyPatch()
    pins = pin_inputs(mp, rng, arrays)
    inputs, steps = family_inputs(arrays)
    int8_spec, int8_state = int8_inputs(rng, arrays)
    spec = dict(pins=[{k: c[k] for k in ("name", "arch", "mesh", "want")} for c in pins],
                steps=steps, int8=int8_spec)
    write_inputs(tmp, arrays, spec)
    handle = ranks.start("families", tmp)
    # While the ranks run: JAX's steps in threads (XLA compiles with the GIL
    # released) and the dry-run's count of each recorded step here.
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        jax_steps = pool.map(jax_family_step, inputs.values())
        dry = {c["name"]: dry_run_collectives(c, inputs[c["state"]]) for c in steps
               if c["record"]}
        jax_steps = dict(zip(inputs, jax_steps))
    out_arrays, out, seconds = ranks.wait(handle)
    return dict(arrays=arrays, out=out, out_arrays=out_arrays, pins=pins, inputs=inputs,
                steps={c["name"]: c for c in steps}, jax_steps=jax_steps, dry=dry,
                int8_state=int8_state, seconds=seconds)


def dry_run_collectives(case, inputs):
    """The collectives the dry-run counts for a step case: the same config,
    optimizer and batch shapes on a fake world of 8 ranks on meta."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun

    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
             for k, v in inputs["batch"].items()}
    with dryrun.fake_world(RANKS):
        mesh = DeviceMesh("cpu", torch.arange(RANKS).reshape(case["mesh"]),
                          mesh_dim_names=("pod", "data", "model"))
        return dryrun.mesh_train_count(inputs["cfg"], OptConfig(**inputs["opt"]), mesh, batch,
                                       policy=case["policy"]).collectives


@pytest.mark.parametrize("case", PINS, ids=[c["name"] for c in PINS])
def test_moe_pins_match_the_reference(families_run, case):
    """(h) Each pin's placements are those of the reference's spec; the MoE
    output and aux metrics on the mesh are JAX's one-device ones."""
    want = next(c for c in families_run["pins"] if c["name"] == case["name"])
    row = families_run["out"]["pins"][case["name"]]
    assert len(row["got"]) == len(want["want"]) == 3
    assert row["got"] == row["want"], row
    ep = case["mesh"][2] == 2  # 4 experts divide a 2-way 'model'
    assert ("Shard(dim=1)" in row["got"][0]) == ep, row["got"]
    assert ("Shard(dim=3)" in row["got"][1]) == (not ep), row["got"]
    y = families_run["out_arrays"][f"pins/{case['name']}/y"]
    assert np.abs(y - want["y"]).max() <= MOE_Y_RTOL * np.abs(want["y"]).max()
    for k, v in want["aux"].items():
        np.testing.assert_allclose(row["aux"][k], v, rtol=MOE_AUX_RTOL)


def assert_step_matches(row, got_params, want, lr):
    """Loss, grad norm and masters against JAX's one-device step, by the
    tolerances of (d)."""
    np.testing.assert_allclose(row["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL)
    tol = (smoke.PARITY_METRIC_RTOL * want["metrics"]["grad_norm"]
           + (RANKS + 1) * BF16_HALF_STEP * row["abs_partial_norm"])
    assert abs(row["grad_norm"] - want["metrics"]["grad_norm"]) <= tol, (row, want["metrics"])
    far = total = 0
    for name, w in want["params"].items():
        d = np.abs(got_params[name] - w)
        assert d.max() <= 2 * lr, name
        if name not in row["partial"]:
            far += int((d > smoke.PARITY_PARAM_FAR).sum())
            total += d.size
    assert far <= smoke.PARITY_PARAM_SHARE * max(total, 1), (far, total)


def step_params(run, name):
    prefix = f"steps/{name}/params/"
    return {k[len(prefix):]: v for k, v in run["out_arrays"].items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", FAMILY_STEPS, ids=[c["name"] for c in FAMILY_STEPS])
def test_family_train_step(families_run, case):
    """(i) The smoke step on the mesh under the family's training policy
    against JAX's one-device step."""
    row = families_run["out"]["steps"][case["name"]]
    state = families_run["steps"][case["name"]]["state"]
    assert families_run["steps"][case["name"]]["policy"] == (
        "fsdp" if case["arch"] == "seamless_m4t_large_v2" else "tp")
    assert_step_matches(row, step_params(families_run, case["name"]),
                        families_run["jax_steps"][state], TRAIN_LR)


def test_int8_moments_on_the_mesh(families_run):
    """(j) scout's int8 step on (2, 2, 2): its q/s, gathered, are JAX's
    update of the mesh's own gradients from the same state, and so are the
    masters (their match to JAX's whole step is in (i))."""
    name = "scout-int8/222"
    inp = families_run["inputs"]["scout-int8"]
    tree, out = inp["tree"], families_run["out_arrays"]
    grads = {k[len(f"steps/{name}/grads/"):]: v for k, v in out.items()
             if k.startswith(f"steps/{name}/grads/")}
    jgrads = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()}
    flat_params = flatten(tree.params)
    st = jopt.AdamState(m=jax.tree.map(jnp.asarray, flatten_moments(tree.opt.m)),
                        v=jax.tree.map(jnp.asarray, flatten_moments(tree.opt.v)),
                        step=jnp.asarray(tree.opt.step))
    new_p, new_st, _ = jopt.update(jtrain.OptConfig(**inp["opt"]),
                                   {k: jnp.asarray(v) for k, v in flat_params.items()},
                                   jgrads, st)
    got_p = step_params(families_run, name)
    for k, w in new_p.items():
        np.testing.assert_allclose(got_p[k], np.asarray(w), rtol=MASTER_RTOL, atol=MASTER_ATOL,
                                   err_msg=k)
    for which in ("m", "v"):
        for k, qs in getattr(new_st, which).items():
            q = out[f"steps/{name}/{which}/q/{k}"].astype(np.int32)
            dq = np.abs(q - np.asarray(qs["q"]).astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).sum() <= Q8_SHARE * dq.size, (which, k)
            np.testing.assert_allclose(out[f"steps/{name}/{which}/s/{k}"], np.asarray(qs["s"]),
                                       rtol=SCALE_RTOL, err_msg=f"{which}/{k}")


def flatten_moments(tree):
    """A JAX moments tree (nested by path, int8 {"q", "s"} at the leaves)
    flat by parameter name."""
    out = {}

    def walk(node, prefix):
        if set(node) == {"q", "s"}:
            out[prefix[:-1]] = dict(node)
            return
        for k, v in node.items():
            walk(v, f"{prefix}{k}.")

    walk(tree, "")
    return out


def test_int8_update_on_shards(families_run):
    """(j) The hand-laid-out update against JAX's on the whole tensors; a
    split at whole blocks stays split, one inside a block ends as it was
    laid out."""
    out, state = families_run["out_arrays"], families_run["int8_state"]
    arrays = families_run["arrays"]
    names = [n for n, *_ in INT8_TREE]
    st = jopt.AdamState(m={n: jax.tree.map(jnp.asarray, state["m"][n]) for n in names},
                        v={n: jax.tree.map(jnp.asarray, state["v"][n]) for n in names},
                        step=jnp.asarray(1, jnp.int32))
    new_p, new_st, metrics = jopt.update(
        jtrain.OptConfig(**INT8_OPT), {n: jnp.asarray(arrays[f"int8/p/{n}"]) for n in names},
        {n: jnp.asarray(arrays[f"int8/g/{n}"], jnp.bfloat16) for n in names}, st)
    assert float(metrics["grad_norm"]) < 1.0  # the clip scale is 1 on both sides
    for n in names:
        np.testing.assert_allclose(out[f"int8/out/p/{n}"], np.asarray(new_p[n]),
                                   rtol=MASTER_RTOL, atol=MASTER_ATOL, err_msg=n)
        for which in ("m", "v"):
            q = out[f"int8/out/{which}/q/{n}"].astype(np.int32)
            dq = np.abs(q - np.asarray(getattr(new_st, which)[n]["q"]).astype(np.int32))
            assert dq.max() <= 1 and (dq > 0).sum() <= Q8_SHARE * dq.size, (which, n)
            np.testing.assert_allclose(out[f"int8/out/{which}/s/{n}"],
                                       np.asarray(getattr(new_st, which)[n]["s"]),
                                       rtol=SCALE_RTOL, err_msg=f"{which}/{n}")
    split = list(out["int8/out/m/q/whole_blocks/placements"])
    assert split[2] == "Shard(dim=1)", split



@pytest.mark.parametrize("case", COLLECTIVE_STEPS, ids=[c["name"] for c in COLLECTIVE_STEPS])
def test_collectives_match_the_dry_run(families_run, case):
    """(k) The collectives of the step on the 8 gloo ranks (rank 0's) are,
    record for record, those the dry-run counts for the same config, state
    and batch shapes on a fake world of 8 on meta."""
    got = families_run["out"]["steps"][case["name"]]["collectives"]
    want = families_run["dry"][case["name"]]
    assert got and sum(c["count"] for c in got) > 0
    key = lambda c: (c["op"], c["result_bytes"], c["explicit_groups"], c["count"])  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
