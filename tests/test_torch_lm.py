"""The port's LM against the JAX LM on weights bridged from a JAX ``init``.

On the smoke configs of the dense and VLM families, in f32, ``apply``,
``prefill`` (last-position logits and the zero-padded KV caches) and
``decode_step`` agree with JAX at 2e-3, the model-level tolerance of
tests/models/test_smoke.py.  Also: one bf16 case, the weight and state
bridge, and that ``get_model`` builds every config's family.  The SSM and
hybrid families are held by tests/test_torch_ssm.py, MoE by
tests/test_torch_moe.py, the encoder-decoder by tests/test_torch_encdec.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import LM, get_model
from repro_torch.weights import flatten, load_jax_params, state_from_jax, to_tensor

TOL = 2e-3
# bf16: both packages round at the same places, but their matmuls sum in
# different orders, so each rounding may land one bf16 step (2^-8 relative)
# apart, and a 2-layer residual stream carries a few such steps into logits
# of magnitude ~0.2; 2e-2 is a few bf16 steps at that magnitude.
TOL_BF16 = 2e-2
DENSE_ARCHS = ["stablelm_12b", "gemma2_2b", "gemma3_4b", "starcoder2_15b", "chameleon_34b"]
B, S, MAX_LEN = 2, 12, 16


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def bridged(arch, dtype="float32", seed=0):
    """(JAX model, JAX params, port model with the same weights, tokens)."""
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if jcfg.qk_norm or jcfg.post_norm:  # nonzero norms, so those branches matter
        def shift(path, a):
            name = str(getattr(path[-1], "key", ""))
            return a + jnp.asarray(0.1, a.dtype) if "ln" in name or "norm" in name else a

        jparams = jax.tree_util.tree_map_with_path(shift, jparams)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = get_model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, to_numpy(jparams))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jmodel, jparams, model, tokens


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_apply(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    close(model.apply(torch.from_numpy(tokens)), jmodel.apply(jparams, jnp.asarray(tokens)))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_then_decode(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
    close(logits, jlogits)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [S] * B
    for got, want in zip(state["kv"], jstate["kv"]):
        assert tuple(got.shape) == want.shape
        close(got, want)
        assert not got[:, :, S:].any()  # zero past the prompt

    nxt = np.array([[3], [7]], np.int32)
    jl2, jstate2 = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l2, state2 = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2)
    close(state2["kv"][0], jstate2["kv"][0])
    assert state2["pos"].tolist() == [S + 1] * B
    # and from JAX's own state, bridged
    l3, _ = model.decode_step(state_from_jax(to_numpy(jstate), device="cpu"),
                              torch.from_numpy(nxt))
    close(l3, jl2)


def test_bf16_prefill_and_decode():
    jmodel, jparams, model, tokens = bridged("stablelm_12b", dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    close(logits, jlogits, TOL_BF16)
    nxt = np.array([[5], [1]], np.int32)
    jl2, _ = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l2, _ = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2, TOL_BF16)


def test_bridge_round_trip_bf16():
    jcfg = jax_smoke_config("stablelm_12b")  # bfloat16
    jparams = to_numpy(jax_get_model(jcfg).init(jax.random.PRNGKey(3)))
    model = get_model(get_smoke_config("stablelm_12b")).init(
        torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(model, jparams)
    got = {n: p.detach() for n, p in model.named_parameters()}
    for name, arr in flatten(jparams).items():
        assert arr.dtype == ml_dtypes.bfloat16
        back = got[name].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(back, arr)
    assert to_tensor(np.float32([1.5])).dtype == torch.float32


def test_bridge_rejects_mismatches():
    jparams = to_numpy(jax_get_model(jax_smoke_config("stablelm_12b").replace(
        dtype="float32")).init(jax.random.PRNGKey(0)))
    model = get_model(get_smoke_config("stablelm_12b").replace(dtype="float32")).init(
        torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(KeyError):
        load_jax_params(model, {k: v for k, v in jparams.items() if k != "unembed"})
    bad = dict(jparams, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        load_jax_params(model, bad)
    with pytest.raises(KeyError):
        state_from_jax({"pos": np.zeros(2, np.int32)}, device="cpu")


def test_init_shapes_and_scales():
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32", d_model=256, d_ff=512)
    model = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jp = to_numpy(jax_get_model(jax_smoke_config("stablelm_12b").replace(
        dtype="float32", d_model=256, d_ff=512)).init(jax.random.PRNGKey(0)))
    flat = flatten(jp)
    for name, p in model.named_parameters():
        assert tuple(p.shape) == flat[name].shape, name
        want = float(np.std(flat[name]))
        assert abs(float(p.std()) - want) <= 0.05 * want + 1e-6, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_model_builds_every_family(arch):
    """Every config's family has its model: the same class as JAX's
    ``get_model`` gives, with JAX's parameter tree key for key, shape for
    shape and type for type."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    jmodel = jax_get_model(jax_smoke_config(arch))
    assert type(model).__name__ == type(jmodel).__name__
    assert model.cfg.family == cfg.family
    flat = flatten(to_numpy(jmodel.init(jax.random.PRNGKey(0))))
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(flat)
    for name, arr in flat.items():
        want = to_tensor(arr)
        assert params[name].shape == want.shape and params[name].dtype == want.dtype, name
