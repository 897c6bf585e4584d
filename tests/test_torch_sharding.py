"""The port's partition rules against the reference's, as data.

* ``param_specs``, ``batch_spec`` and ``decode_state_specs`` give, for each
  of the ten configs at full size, both policies and the axis dicts of the
  single-pod (16, 16) and multi-pod (2, 16, 16) meshes, the reference's
  ``PartitionSpec`` of every leaf, padded to the leaf's rank.  The JAX side
  is built with ``jax.eval_shape``, the port's on ``meta``.
* ``state_specs`` does so for the whole training state under the
  dry-run's optimizer settings, the int8 ``q``/``s`` moments of grok-1 and
  llama4-scout included.
* ``to_placements`` on a fake process group of 256 and 512 ranks gives
  every leaf the DTensor local shape that the spec's arithmetic gives, and
  raises where DTensor would lay a tensor out otherwise than the reference.
"""

import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.coord.elastic import state_specs as jax_state_specs
from repro.models import get_model as jax_get_model
from repro.models import sharding as jax_sharding
from repro.train import OptConfig as JaxOptConfig
from repro.train import init_state as jax_init_state
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.coord import state_specs
from repro_torch.launch.dryrun import fake_world, make_mesh, meta_train_state, opt_config
from repro_torch.models import get_model, sharding
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

MESH_AXES = {"16x16": {"data": 16, "model": 16},
             "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SERVING = sorted({(b, s) for s, b, kind in SHAPES.values() if kind != "train"})


def _key(k) -> str:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return k.name
    return f"[{k.idx}]"


def jax_flat(specs, shapes):
    """Dotted path -> (spec padded to the leaf's rank) of a JAX spec tree."""
    flat_specs = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    flat_shapes = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [p for p, _ in flat_specs] == [p for p, _ in flat_shapes]
    return {".".join(_key(k) for k in path): tuple(spec) + (None,) * (leaf.ndim - len(spec))
            for (path, spec), (_, leaf) in zip(flat_specs, flat_shapes)}


def port_flat(specs, tensors, prefix=""):
    """The same of the port's spec tree, walked along its tensors' tree;
    without ``specs``, the tensors' shapes."""
    if isinstance(tensors, torch.Tensor):
        if specs is None:
            return {prefix[:-1]: tuple(tensors.shape)}
        assert len(specs) == tensors.dim()
        return {prefix[:-1]: specs}
    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.named_parameters())
    if isinstance(tensors, dict):
        items = [(k, t, None if specs is None else specs[k]) for k, t in tensors.items()]
    else:
        keys = getattr(tensors, "_fields", None) or [f"[{i}]" for i in range(len(tensors))]
        items = list(zip(keys, tensors, [None] * len(keys) if specs is None else specs))
    out = {}
    for k, t, s in items:
        out.update(port_flat(s, t, f"{prefix}{k}."))
    return out


def local_shape(shape, spec, axes):
    """The spec's arithmetic for one device: each dim over the product of
    its axes, rounded up as JAX pads it."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(-(-n // math.prod(axes[a] for a in names)))
    return tuple(out)


_JAX_PARAMS = {}


def jax_params(arch):
    if arch not in _JAX_PARAMS:
        model = jax_get_model(jax_get_config(arch))
        _JAX_PARAMS[arch] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return _JAX_PARAMS[arch]


def test_shapes_match_the_reference():
    assert SHAPES == JAX_SHAPES


@pytest.mark.parametrize("mesh", list(MESH_AXES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match(arch, mesh):
    axes = MESH_AXES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = dict(get_model(cfg).named_parameters())
    shapes = jax_params(arch)
    for policy in ("tp", "fsdp"):
        want = jax_flat(jax_sharding.param_specs(jcfg, shapes, axes, policy=policy), shapes)
        got = sharding.param_specs(cfg, params, axes, policy=policy)
        assert got == want, policy
    for kind in ("train", "prefill", "decode"):
        assert sharding.policy_for(cfg, kind) == jax_sharding.policy_for(jcfg, kind)


@pytest.mark.parametrize("mesh", list(MESH_AXES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_state_specs_match(arch, mesh):
    axes = MESH_AXES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for seq, batch, _ in SHAPES.values():
        for shape in [(batch, seq), (batch, 1), (batch, seq, cfg.d_model)]:
            for policy in ("tp", "fsdp"):
                want = jax_sharding.batch_spec(jcfg, shape, axes, policy)
                assert sharding.batch_spec(cfg, shape, axes, policy) == \
                    tuple(want) + (None,) * (len(shape) - len(want))
    model, jmodel = get_model(cfg), jax_get_model(jcfg)
    for batch, seq in SERVING:
        if cfg.family == "encdec":
            memory = torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=torch.bfloat16,
                                 device="meta")
            state = model.decode_init(batch, seq, memory)
            jmem = jax.ShapeDtypeStruct((batch, cfg.enc_len, cfg.d_model), "bfloat16")
            jstate = jax.eval_shape(lambda p, m: jmodel.decode_init(p, batch, seq, m),
                                    jax_params(arch), jmem)
        else:
            state = model.decode_init(batch, seq)
            jstate = jax.eval_shape(lambda: jmodel.decode_init(batch, seq))
        want = jax_flat(jax_sharding.decode_state_specs(jcfg, jstate, axes), jstate)
        got = port_flat(sharding.decode_state_specs(cfg, state, axes), state)
        assert got == want, (batch, seq)
        assert port_flat(None, state) == {
            ".".join(_key(k) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]}


_STATES = {}


def train_states(arch):
    """(port meta TrainState, JAX abstract TrainState) under the dry-run's
    optimizer settings (int8 moments above 60e9 params)."""
    if arch not in _STATES:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        ocfg = opt_config(cfg)  # the reference's dry-run rule
        assert ocfg.int8_state == (jcfg.param_count() > 60e9)
        jocfg = JaxOptConfig(int8_state=ocfg.int8_state)
        _STATES[arch] = (meta_train_state(cfg, ocfg), jax.eval_shape(
            lambda: jax_init_state(jcfg, jocfg, jax.random.PRNGKey(0))))
    return _STATES[arch]


@pytest.mark.parametrize("mesh", list(MESH_AXES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match(arch, mesh):
    axes = MESH_AXES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    state, jstate = train_states(arch)
    int8 = cfg.param_count() > 60e9
    assert isinstance(state.opt.m["embed"], dict) == int8
    for policy in ("tp", "fsdp"):
        want = jax_flat(jax_state_specs(jcfg, jstate, axes, policy=policy), jstate)
        got = port_flat(state_specs(cfg, state, axes, policy=policy), state)
        assert got == want, policy
        if int8:  # the moments' q/s specs are there, and some shard
            qs = [s for k, s in got.items() if k.startswith("opt.m.") and k.endswith(".q")]
            assert qs and any(any(e is not None for e in s) for s in qs)


@pytest.mark.parametrize("mesh", list(MESH_AXES))
def test_placements_give_the_spec_local_shapes(mesh):
    """Every leaf of every config's specs, on a fake process group of the
    mesh's size: DTensor's local shape is the spec's arithmetic."""
    axes = MESH_AXES[mesh]
    checked = 0
    with fake_world(math.prod(axes.values())):
        dmesh = make_mesh(mesh)
        assert sharding.axis_sizes(dmesh) == axes
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            state, _ = train_states(arch)
            trees = [port_flat(state_specs(cfg, state, axes, policy=p), state)
                     for p in ("tp", "fsdp")]
            model = get_model(cfg)
            if cfg.family != "encdec":
                dstate = model.decode_init(128, 32768)
                trees.append(port_flat(sharding.decode_state_specs(cfg, dstate, axes), dstate))
                shapes = {**port_flat(None, state), **port_flat(None, dstate)}
            else:
                shapes = port_flat(None, state)
            for specs in trees:
                for name, spec in specs.items():
                    local, _ = compute_local_shape_and_global_offset(
                        shapes[name], dmesh, sharding.to_placements(spec, dmesh, shapes[name]))
                    assert tuple(local) == local_shape(shapes[name], spec, axes), name
                    checked += 1
    assert checked > 1000


def test_to_placements_examples_and_refusals():
    with fake_world(512):
        dmesh = make_mesh("2x16x16")
        Shard, Replicate = torch.distributed.tensor.Shard, torch.distributed.tensor.Replicate
        # grok-1's stacked expert w_in under TP-within-expert
        spec = (None, None, "data", "model")
        assert sharding.to_placements(spec, dmesh, (64, 8, 6144, 32768)) == [
            Replicate(), Shard(2), Shard(3)]
        assert local_shape((64, 8, 6144, 32768), spec, sharding.axis_sizes(dmesh)) \
            == (64, 8, 384, 2048)
        # a dp tuple: one dim over two mesh dims, outermost first
        assert sharding.to_placements((("pod", "data"), None), dmesh, (131072, 4)) == [
            Shard(0), Shard(0), Replicate()]
        assert local_shape((131072, 4), (("pod", "data"), None),
                                    sharding.axis_sizes(dmesh)) == (4096, 4)
        with pytest.raises(ValueError, match="mesh order"):
            sharding.to_placements((("data", "pod"),), dmesh, (64,))
        with pytest.raises(ValueError, match="does not divide"):
            sharding.to_placements(("model",), dmesh, (8,))
        with pytest.raises(ValueError, match="two dims"):
            sharding.to_placements(("data", "data"), dmesh, (16, 16))
        with pytest.raises(ValueError, match="not in mesh"):
            sharding.to_placements(("expert",), dmesh, (16,))
    assert not torch.distributed.is_initialized()
