"""Serving on a device mesh on 8 gloo ranks on the CPU, against the JAX package.

The ranks are ``tests/multidevice_ranks.py``'s (group "serve": spawned
processes joined through a ``FileStore``, one thread each, importing only
``repro_torch``), launched once by a module-scoped fixture; JAX's
one-device steps and the dry-run's counts run here while they do.  Each of
ten smoke configs (f32) goes through the port's ``Engine.generate``
(greedy, 7 tokens: the prefill and 7 decode steps, the last of which
feeds the seventh token back) under ``set_mesh``,
the model placed by ``param_specs(..., "tp")``, on two (pod, data, model)
meshes:

* (2, 2, 2): the batch over ('pod', 'data'), the smoke configs' 2 or 4 KV
  heads over 'model' (the caches' heads split);
* (1, 1, 8): 2 and 4 KV heads do not divide 'model', so the caches'
  sequence splits (``decode_state_specs``), each rank attends its shard
  and the ranks merge their partials; gemma2's and gemma3's windows of 8
  cross the shards of 3 entries and leave some empty; mamba2's conv window
  (its channels split evenly) is gathered at use.

Against JAX's one-device ``make_prefill_step`` and ``make_decode_step`` on
the same weights (bridged by ``repro_torch.weights``), run as its Engine
runs them (argmax of the last logits fed back):

(a) the logits of the prefill and of each decode step;
(b) the greedy tokens of ``Engine.generate``;
(c) the decode state's placements after the prefill and after every
    decode step: ``to_placements`` of the spec that the reference's own
    ``decode_state_specs`` gives for its state;
(d) the collectives of the prefill step and of a decode step on the ranks
    (rank 0's) equal, record for record, those ``dryrun.mesh_serving_count``
    counts on a fake world of 8 on meta;
(e) both steps go through the Engine's captured steps (``serve.graph``;
    uncaptured on the CPU, on the static buffers that the card captures
    with): one captured prefill and one decode step, every buffer a
    DTensor, every decode step returning the captured step's own state.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import multidevice_ranks as ranks
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import sharding as jsharding
from repro.serve import make_decode_step as jax_decode_step
from repro.serve import make_prefill_step as jax_prefill_step
from repro_torch.configs import get_smoke_config
from repro_torch.weights import flatten

ARCHS = {"stablelm": "stablelm_12b", "gemma2": "gemma2_2b", "gemma3": "gemma3_4b",
         "starcoder2": "starcoder2_15b", "chameleon": "chameleon_34b",
         "mamba2": "mamba2_2p7b", "zamba2": "zamba2_1p2b", "seamless": "seamless_m4t_large_v2",
         "grok": "grok_1_314b", "scout": "llama4_scout_17b_a16e"}
MESHES = {"222": [2, 2, 2], "118": [1, 1, 8]}
CASES = [dict(name=f"{short}/{m}", arch=arch, mesh=MESHES[m])
         for short, arch in ARCHS.items() for m in MESHES]
B = 4
STEPS = 7  # tokens: the prefill's and six decode steps'; seven decode steps run
# Prompts: 12 tokens (two smoke SSM chunks, 32, for the SSM families); the
# caches hold 24 (40) entries, a multiple of the 8-way 'model' axis, so
# that the sequence splits there (shards of 3 or 5 entries).
PROMPT, MAX_LEN = {"ssm": (32, 40), "hybrid": (32, 40)}, (12, 24)
# (a) The one-device parity tolerance of tests/test_torch_lm.py (rtol and
# atol 2e-3, the port against JAX in f32 through prefill and decode): the
# mesh adds only the f32 sums of its gathers, partial sums and the decode
# merge in other orders (~1e-6 relative).
TOL = 2e-3
JAX_THREADS = 3


def _entries(spec, rank):
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]
    return out + [None] * (rank - len(out))


def _flat_specs(specs, shapes, prefix=""):
    """(path, JSON entries) of the reference's spec tree, paths as the
    ranks' ``_flat_state`` names them."""
    if isinstance(specs, PartitionSpec):
        yield prefix[:-1], _entries(specs, len(shapes.shape))
    elif isinstance(specs, dict):
        for k in specs:
            yield from _flat_specs(specs[k], shapes[k], f"{prefix}{k}.")
    else:
        for i, (s, x) in enumerate(zip(specs, shapes)):
            yield from _flat_specs(s, x, f"{prefix}{i}.")


def lengths(cfg):
    return PROMPT.get(cfg.family, MAX_LEN)


def jax_inputs(arch, arrays):
    """The JAX weights and batch of ``arch`` (f32 smoke, seeds 0 and 1),
    written for the ranks; (jcfg, params, batch)."""
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    params = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompt, _ = lengths(jcfg)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, prompt)).astype(np.int32)}
    if jcfg.family == "encdec":
        batch["enc_emb"] = rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)).astype(
            np.float32)
    arrays.update({f"serve/{arch}/params/{k}": np.asarray(v)
                   for k, v in flatten(jax.tree.map(np.asarray, params)).items()})
    arrays.update({f"serve/{arch}/batch/{k}": v for k, v in batch.items()})
    return jcfg, params, batch


def jax_specs(jcfg, params, batch, mesh):
    """The reference's ``decode_state_specs`` of its prefill's state on a
    mesh of these axis sizes, by path."""
    _, max_len = lengths(jcfg)
    state = jax.eval_shape(jax_prefill_step(jcfg, max_len), params,
                           {k: jnp.asarray(v) for k, v in batch.items()})[1]
    sizes = dict(zip(("pod", "data", "model"), mesh))
    return dict(_flat_specs(jsharding.decode_state_specs(jcfg, state, sizes), state))


def jax_greedy(jcfg, params, batch):
    """JAX's one-device prefill and decode steps, each step's argmax fed
    back as its Engine does: the logits (STEPS + 1, B, V) of the prefill and
    of each decode step, and the tokens (B, STEPS)."""
    _, max_len = lengths(jcfg)
    prefill = jax.jit(jax_prefill_step(jcfg, max_len))
    decode = jax.jit(jax_decode_step(jcfg))
    logits, state = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    out, tokens = [np.asarray(logits[:, -1])], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        tokens.append(np.asarray(nxt))
        logits, state = decode(params, state, nxt[:, None].astype(jnp.int32))
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out), np.stack(tokens, axis=1)


def dry_run_collectives(case, batch):
    """The collectives the dry-run counts for a case's prefill and decode
    steps: the same config and shapes on a fake world of 8 ranks on meta."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun

    cfg = get_smoke_config(case["arch"]).replace(dtype="float32", sharding_policy="tp")
    _, max_len = lengths(cfg)
    meta = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
            for k, v in batch.items()}
    out = {}
    with dryrun.fake_world(ranks.WORLD):
        mesh = DeviceMesh("cpu", torch.arange(ranks.WORLD).reshape(case["mesh"]),
                          mesh_dim_names=("pod", "data", "model"))
        out["prefill"] = dryrun.mesh_serving_count(cfg, mesh, "prefill", meta, max_len).collectives
        tok = {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}
        out["decode"] = dryrun.mesh_serving_count(cfg, mesh, "decode", tok, max_len).collectives
    return out


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """One launch of the 8 ranks for every case; JAX's greedy steps and
    the dry-run's counts run here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("serve"))
    arrays, inputs, cases = {}, {}, []
    for arch in ARCHS.values():
        inputs[arch] = jax_inputs(arch, arrays)
    for case in CASES:
        jcfg, params, batch = inputs[case["arch"]]
        cases.append(dict(case, specs=jax_specs(jcfg, params, batch, case["mesh"]),
                          batch_keys=sorted(batch), max_len=lengths(jcfg)[1], steps=STEPS))
    np.savez(os.path.join(tmp, "in.npz"), **arrays)
    with open(os.path.join(tmp, "in.json"), "w") as f:
        json.dump(dict(serve=cases), f)
    handle = ranks.start("serve", tmp)
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        greedy = pool.map(lambda a: jax_greedy(*inputs[a]), ARCHS.values())
        dry = {c["name"]: dry_run_collectives(c, inputs[c["arch"]][2]) for c in CASES}
        greedy = dict(zip(ARCHS.values(), greedy))
    out_arrays, out, seconds = ranks.wait(handle, timeout=300)
    return dict(out=out, out_arrays=out_arrays, cases={c["name"]: c for c in cases},
                greedy=greedy, dry=dry, seconds=seconds)


IDS = [c["name"] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_logits_match_jax(serve_run, case):
    """(a) The prefill's and every decode step's logits on the mesh against
    JAX's one-device steps."""
    got = serve_run["out_arrays"][f"{case['name']}/logits"]
    want, _ = serve_run["greedy"][case["arch"]]
    assert got.shape == want.shape == (STEPS + 1, B, get_smoke_config(case["arch"]).vocab)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_greedy_tokens_match_jax(serve_run, case):
    """(b) ``Engine.generate``'s greedy tokens on the mesh are JAX's."""
    _, want = serve_run["greedy"][case["arch"]]
    np.testing.assert_array_equal(serve_run["out_arrays"][f"{case['name']}/tokens"], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_placements_are_the_reference_specs(serve_run, case):
    """(c) After the prefill and after each decode step, each leaf of the
    decode state is laid out as the reference's ``decode_state_specs``
    says; on (1, 1, 8) the caches of 2 or 4 KV heads split their sequence."""
    row = serve_run["out"][case["name"]]
    want = row["want"]
    assert len(row["placements"]) == STEPS + 1
    assert set(want) == set(serve_run["cases"][case["name"]]["specs"])
    for step in row["placements"]:
        assert step == want, (step, want)
    for path in ("kv.0", "shared_kv.1"):
        if path in want:
            split = "Shard(dim=2)" if case["mesh"] == MESHES["118"] else "Shard(dim=3)"
            assert want[path][2] == split, want[path]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_match_the_dry_run(serve_run, case):
    """(d) The collectives of the prefill and of a decode step on the ranks
    are, record for record, those the dry-run counts on a fake world of 8;
    a decode step over a sequence-split cache merges its partials with
    all-reduces."""
    got = serve_run["out"][case["name"]]["collectives"]
    want = serve_run["dry"][case["name"]]
    key = lambda c: (c["op"], c["result_bytes"], c["explicit_groups"], c["count"])  # noqa: E731
    for kind in ("prefill", "decode"):
        assert got[kind] and sum(c["count"] for c in got[kind]) > 0
        assert sorted(map(key, got[kind])) == sorted(map(key, want[kind])), kind
    family = get_smoke_config(case["arch"]).family
    if case["mesh"] == MESHES["118"] and family in ("dense", "moe", "encdec", "hybrid"):
        assert any(c["op"] == "all-reduce" for c in got["decode"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_mesh_engine_runs_its_captured_steps(serve_run, case):
    """(e) Under ``set_mesh`` the Engine's prefill and decode step are its
    captured steps, on DTensor buffers: one layout each, and every decode
    step hands back the captured step's static state."""
    row = serve_run["out"][case["name"]]
    assert row["captured"] == {"prefill": [[True]], "decode": [[True]]}, row["captured"]
    assert row["static_states"] == [True] * STEPS
