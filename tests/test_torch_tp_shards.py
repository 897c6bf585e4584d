"""Serving on a mesh contracts on weight shards, as the reference's ``tp`` does.

The reference serves under its ``tp`` policy (``repro.models.sharding``):
XLA partitions each matmul on the weight's 'model' shard, so a prefill or
decode step moves activations over 'model' and gathers a weight only over
'data' (FSDP of its input dim).  Here the reference's prefill and decode
step of two smoke configs (stablelm, dense; mamba2, whose in_proj's
'model' shard does not follow its heads) are compiled for 8 host devices on
the meshes (1, 1, 8) and (2, 2, 2) under its own ``param_specs(..., "tp")``,
in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
and their collectives read with ``repro.launch.hlo_analysis.analyze``.  The
port's same steps are counted by ``dryrun.mesh_serving_count`` on a fake
world of 8 on meta.  Both sides' per-device bytes are the ring-model
traffic of ``roofline.collective_traffic``.

* The port moves at most ``FACTOR`` times the reference's bytes.  The port
  gathers each weight over 'data' at its use, where XLA may move the
  (smaller) activations instead; at (2, 2, 2) those weight gathers carry up
  to the reference's own all-gather bytes, hence a factor of 2.  A port
  that gathers every weight whole at use misses it by about the 'model'
  size at decode (4.3x and 3.9x at (2, 2, 2), 31x and 20x at (1, 1, 8)).
* No all-gather over 'model' carries a weight that the tp specs split over
  'model': none of its records' result sizes is such a weight's, in any
  layout it can be gathered from (its 'model' dim whole, each subset of
  its other axes gathered, a layer of the stack or the whole stack); in
  the serving steps above, and in the train step of the families that
  train under tp (``dryrun.mesh_train_count``: the MoE, SSM and hybrid
  smoke configs, the loss on the unembedding's vocabulary shards).
"""

import itertools
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model
from repro_torch.models.sharding import param_specs

ARCHS = ("stablelm_12b", "mamba2_2p7b")
MESHES = {"118": (1, 1, 8), "222": (2, 2, 2)}
KINDS = ("prefill", "decode")
CASES = [dict(name=f"{a}/{m}/{k}", arch=a, mesh=m, kind=k)
         for a in ARCHS for m in MESHES for k in KINDS]
IDS = [c["name"] for c in CASES]
B = 4
FACTOR = 2.0
AXES = ("pod", "data", "model")


def lengths(cfg):
    """(prompt, cache) lengths: two smoke SSM chunks for the SSM families."""
    return (32, 40) if cfg.family in ("ssm", "hybrid") else (12, 24)


def config(arch):
    return get_smoke_config(arch).replace(dtype="float32", sharding_policy="tp")


REFERENCE = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch import hlo_analysis
    from repro.models import get_model
    from repro.models.sharding import (axis_sizes, batch_spec, decode_state_specs, named,
                                       param_specs)
    from repro.serve import make_decode_step, make_prefill_step

    assert len(jax.devices()) == 8
    B = %(B)d
    out = {}
    for arch in %(archs)r:
        cfg = get_smoke_config(arch).replace(dtype="float32", sharding_policy="tp")
        S, L = (32, 40) if cfg.family in ("ssm", "hybrid") else (12, 24)
        model = get_model(cfg)
        for name, shape in %(meshes)r.items():
            mesh = Mesh(np.array(jax.devices()).reshape(shape), ("pod", "data", "model"))
            sizes = axis_sizes(mesh)
            leaf = lambda x: isinstance(x, (jax.ShapeDtypeStruct, P))
            laid = lambda t, s: jax.ShapeDtypeStruct(t.shape, t.dtype,
                                                     sharding=NamedSharding(mesh, s))
            pshapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
            params = jax.tree.map(laid, pshapes, param_specs(cfg, pshapes, sizes, policy="tp"),
                                  is_leaf=leaf)
            tok = lambda s: jax.ShapeDtypeStruct(
                (B, s), jnp.int32, sharding=NamedSharding(mesh, batch_spec(cfg, (B, s), sizes,
                                                                            "tp")))
            prefill = make_prefill_step(cfg, L)
            state = jax.eval_shape(prefill, pshapes, {"tokens": tok(S)})[1]
            sspecs = decode_state_specs(cfg, state, sizes)
            with jax.set_mesh(mesh):
                steps = {
                    "prefill": jax.jit(prefill, out_shardings=(None, named(mesh, sspecs)))
                    .lower(params, {"tokens": tok(S)}),
                    "decode": jax.jit(make_decode_step(cfg),
                                      out_shardings=(None, named(mesh, sspecs)))
                    .lower(params, jax.tree.map(laid, state, sspecs, is_leaf=leaf), tok(1)),
                }
                for kind, lowered in steps.items():
                    hlo = lowered.compile().as_text()
                    out[f"{arch}/{name}/{kind}"] = [
                        {k: c[k] for k in ("op", "result_bytes", "group_size", "count")}
                        for c in hlo_analysis.analyze(hlo).collectives]
    print("REFERENCE_COLLECTIVES " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference():
    """The reference's collectives of each case, by name."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = REFERENCE % dict(B=B, archs=ARCHS, meshes=MESHES)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env, cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [x for x in run.stdout.splitlines() if x.startswith("REFERENCE_COLLECTIVES ")][-1]
    return json.loads(line.split(" ", 1)[1])


@pytest.fixture(scope="module")
def port():
    """The port's collectives of each case, by name."""
    out = {}
    for arch, (name, shape) in itertools.product(ARCHS, MESHES.items()):
        cfg = config(arch)
        prompt, max_len = lengths(cfg)
        with dryrun.fake_world(math.prod(shape)):
            mesh = DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(shape),
                              mesh_dim_names=AXES)
            for kind in KINDS:
                tokens = torch.empty((B, prompt if kind == "prefill" else 1), dtype=torch.int32,
                                     device="meta")
                out[f"{arch}/{name}/{kind}"] = dryrun.mesh_serving_count(
                    cfg, mesh, kind, {"tokens": tokens}, max_len).collectives
    return out


def traffic(collectives):
    t = roofline.collective_traffic(collectives, n_devices=8)
    return t["ici"] + t["dcn"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collective_bytes_within_a_factor_of_the_reference(reference, port, case):
    """The port's per-device collective bytes of the step are at most
    ``FACTOR`` times the reference's (and it moves some: a step on a mesh of
    8 is never free)."""
    ref, got = traffic(reference[case["name"]]), traffic(port[case["name"]])
    assert ref > 0 and got > 0
    assert got <= FACTOR * ref, f"port {got:.0f} B, reference {ref:.0f} B ({got / ref:.2f}x)"


def model_group(shape):
    """Rank 0's group over the 'model' dim of a (pod, data, model) mesh."""
    return list(range(shape[2]))


def weight_sizes(cfg, shape):
    """The byte sizes of every layout in which an all-gather over 'model'
    could hand on a weight that the tp specs split over 'model': its 'model'
    dim whole, each subset of its other split axes gathered or not, one
    layer of a stacked weight or the whole stack."""
    sizes = dict(zip(AXES, shape))
    params = dict(get_model(cfg).named_parameters())
    specs = param_specs(cfg, params, sizes, "tp")
    out = set()
    for name, p in params.items():
        spec = specs[name]
        axes = [(d, a) for d, e in enumerate(spec) for a in ((e,) if isinstance(e, str)
                                                             else (e or ()))]
        if not any(a == "model" for _, a in axes):
            continue
        others = [(d, a) for d, a in axes if a != "model"]
        for keep in itertools.product((False, True), repeat=len(others)):
            local = list(p.shape)
            for (d, a), kept in zip(others, keep):
                if kept:
                    local[d] //= sizes[a]
            n = math.prod(local) * p.element_size()
            out.add(n)
            if name.split(".")[0] in ("blocks", "enc_blocks", "dec_blocks"):
                out.add(n // p.shape[0])  # one layer of the stack
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_no_weight_is_gathered_over_model(port, case):
    """No all-gather over rank 0's 'model' group hands on a weight that the
    tp specs split over 'model' (its records' result sizes are none of
    such a weight's)."""
    shape = MESHES[case["mesh"]]
    weights = weight_sizes(config(case["arch"]), shape)
    group = model_group(shape)
    gathered = [c["result_bytes"] for c in port[case["name"]]
                if c["op"] == "all-gather" and c["explicit_groups"] == [group]]
    assert not weights & set(gathered), sorted(weights & set(gathered))


TRAIN_ARCHS = ("grok_1_314b", "mamba2_2p7b", "zamba2_1p2b")
TRAIN_CASES = [dict(name=f"{a}/{m}", arch=a, mesh=m) for a in TRAIN_ARCHS for m in MESHES]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c["name"] for c in TRAIN_CASES])
def test_no_weight_is_gathered_over_model_in_training(case):
    """The train step under tp (f32 masters, a batch of 4 x 48) gathers no
    weight that the tp specs split over 'model' over rank 0's 'model'
    group, the loss's unembedding included.  The residual's sequence rides
    'model' here, so activations are gathered over it too: 48 positions
    (three smoke SSD chunks) give every activation a factor 3 in its bytes
    that no smoke weight's has."""
    from repro_torch.train import OptConfig

    cfg = config(case["arch"])
    shape = MESHES[case["mesh"]]
    batch = {k: torch.empty((B, 48), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    with dryrun.fake_world(math.prod(shape)):
        mesh = DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(shape),
                          mesh_dim_names=AXES)
        step = dryrun.mesh_train_count(cfg, OptConfig(), mesh, batch, policy="tp")
    group = model_group(shape)
    gathered = {c["result_bytes"] for c in step.collectives
                if c["op"] == "all-gather" and c["explicit_groups"] == [group]}
    weights = weight_sizes(cfg, shape)
    assert not weights & gathered, sorted(weights & gathered)
