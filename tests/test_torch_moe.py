"""The port's MoE FFN and MoE LM against the JAX package.

On the smoke configs of ``grok_1_314b`` (4 experts, top-2) and
``llama4_scout_17b_a16e`` (4 experts, top-1 and a shared expert), in f32:
``moe_apply``'s output and both aux values at capacity factors 0.25 (tokens
dropped), 1.25 and 8.0 and dropless, over two dispatch groups;
``LM.apply``, its layer-mean aux, ``prefill`` (logits and caches) and
``decode_step`` (also from JAX's state, bridged); Engine greedy tokens, at
capacity factor 8.0 as tests/serve/test_engine.py runs the JAX engine.  All
at 2e-3, the model-level tolerance of tests/models/test_smoke.py.  Also
the bf16 router quirk of the reference: its forward pass rounds the f32
router to the compute type, its prefill and decode do not, and so does the
port.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.serve import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine
from repro_torch.weights import flatten, load_jax_params, state_from_jax, to_tensor

TOL = 2e-3
# bf16, as tests/test_torch_lm.py states it: each rounding may land one bf16
# step apart, a 2-layer residual stream carries a few such steps into
# logits of magnitude ~0.2.
TOL_BF16 = 2e-2
MOE_ARCHS = ["grok_1_314b", "llama4_scout_17b_a16e"]
B, S, MAX_LEN = 2, 12, 16


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def configs(arch, dtype="float32", capacity_factor=8.0):
    """(JAX config, the port's config) of the smoke config."""
    kw = dict(dtype=dtype, capacity_factor=capacity_factor)
    return jax_smoke_config(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def bridged(arch, dtype="float32", capacity_factor=8.0, seed=0):
    """(JAX model, JAX params, port model with the same weights, tokens)."""
    jcfg, cfg = configs(arch, dtype, capacity_factor)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = get_model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, to_numpy(jparams))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jmodel, jparams, model, tokens


def tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    return to_tensor(np.asarray(tree))


MODES = [0.25, 1.25, 8.0, "dropless"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", MODES, ids=["cf0.25", "cf1.25", "cf8", "dropless"])
def test_moe_apply(arch, mode):
    """Two groups of 64 tokens (the smoke group size); at 0.25 the capacity
    drops many tokens (at 1.25 a few), which both packages must drop alike;
    at 8.0 and dropless none."""
    dropless = mode == "dropless"
    jcfg, cfg = configs(arch, capacity_factor=1.25 if dropless else mode)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(1), jnp.float32)
    p = tree_to_torch(jp)
    x = np.random.default_rng(2).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), dropless=dropless)
    got_y, got_aux = tmoe.moe_apply(cfg, p, torch.from_numpy(x), dropless=dropless)
    close(got_y, want_y)
    assert sorted(got_aux) == sorted(want_aux) == ["moe_drop_frac", "moe_lb_loss"]
    for name in got_aux:
        np.testing.assert_allclose(got_aux[name].item(), float(want_aux[name]),
                                   rtol=1e-5, atol=1e-6)
    drop = got_aux["moe_drop_frac"].item()
    if mode == 0.25:
        assert drop > 0.1
    elif mode != 1.25:
        assert drop == 0.0


def test_group_size_must_divide_the_tokens():
    _, cfg = configs("grok_1_314b")
    p = tmoe.moe_init(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    with pytest.raises(AssertionError, match="not divisible by group size"):
        tmoe.moe_apply(cfg, p, torch.randn(3, 30, cfg.d_model))  # 90 tokens, groups of 64
    y, _ = tmoe.moe_apply(cfg, p, torch.randn(1, 30, cfg.d_model))  # one group of 30
    assert y.shape == (1, 30, cfg.d_model)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_apply_and_aux(arch, capacity_factor):
    jmodel, jparams, model, tokens = bridged(arch, capacity_factor=capacity_factor)
    close(model.apply(torch.from_numpy(tokens)), jmodel.apply(jparams, jnp.asarray(tokens)))
    _, jaux = jmodel.hidden_states(jparams, jnp.asarray(tokens), remat=False)
    _, aux = model.hidden_states(torch.from_numpy(tokens), with_aux=True)
    assert sorted(aux) == sorted(jaux)
    for name in aux:
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
    close(logits, jlogits)
    for got, want in zip(state["kv"], jstate["kv"]):
        assert tuple(got.shape) == want.shape
        close(got, want)
        assert not got[:, :, S:].any()

    nxt = np.array([[3], [7]], np.int32)
    jl2, jstate2 = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l3, _ = model.decode_step(state_from_jax(to_numpy(jstate), device="cpu"),
                              torch.from_numpy(nxt))
    close(l3, jl2)
    l2, state2 = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2)
    close(state2["kv"][0], jstate2["kv"][0])
    assert state2["pos"].tolist() == [S + 1] * B


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_tokens_match_jax_engine(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    want = JaxEngine(jmodel.cfg, jparams, max_len=24).generate({"tokens": jnp.asarray(tokens)}, 6)
    got = Engine(model, max_len=24, device="cpu").generate({"tokens": torch.from_numpy(tokens)}, 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens, want.tokens)


def routers_seen(monkeypatch):
    """Records the (router, input) of each ``moe_apply`` call of the LM."""
    seen = []

    def spy(cfg, p, x, **kw):
        seen.append((p["router"], x))
        return tmoe.moe_apply(cfg, p, x, **kw)

    monkeypatch.setattr(tlm, "moe_apply", spy)
    return seen


# Router probabilities closer than this to a tie may order differently in
# the two packages: in bf16 their inputs differ by a bf16 step (2^-8
# relative), which moves router logits of size ~1 by ~4e-3 and a
# probability of ~0.25 by ~1e-3; 2e-2 is 20x that.  A flipped choice sends
# the token through another expert, so its logits differ by far more than
# a rounding step.
TIE_MARGIN = 2e-2


def near_ties(cfg, seen):
    """(B, S) mask of the positions whose routing is within ``TIE_MARGIN``
    of a tie (the k-th and (k+1)-th largest probabilities) at any layer."""
    tied = None
    for router, x in seen:
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        t = (top[..., -2] - top[..., -1]) < TIE_MARGIN
        tied = t if tied is None else tied | t
    return tied


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_router_quirk(arch, monkeypatch):
    """In bf16 the reference's forward pass (``_attn_stack`` through
    ``_cast_block``) routes with the router rounded to bf16, its prefill and
    decode with the f32 router.  The port's ``apply`` rounds it and its
    ``prefill`` and ``decode_step`` do not, and each agrees with JAX at
    every position whose routing is not within rounding of a tie (a
    quarter of grok's 24 positions here; at most half are let go)."""
    jmodel, jparams, model, tokens = bridged(arch, dtype="bfloat16")
    cfg, L = model.cfg, model.cfg.n_layers
    router = model.blocks.moe.router
    assert router.dtype == torch.float32 and model.blocks.moe.w_in.dtype == torch.bfloat16
    assert not torch.equal(router, router.bfloat16().float())  # rounding changes it
    seen = routers_seen(monkeypatch)

    got = model.apply(torch.from_numpy(tokens))
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(tokens)), np.float32)
    assert [r.dtype for r, _ in seen] == [torch.bfloat16] * L
    assert all(torch.equal(r, router[i].bfloat16()) for i, (r, _) in enumerate(seen))
    tied = near_ties(cfg, seen)
    assert tied.float().mean().item() <= 0.5
    close(got[~tied], want[~tied.numpy()], TOL_BF16)

    seen.clear()
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    nxt = np.array([[5], [1]], np.int32)
    jl2, _ = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l2, _ = model.decode_step(state, torch.from_numpy(nxt))
    assert [r.dtype for r, _ in seen] == [torch.float32] * (2 * L)
    assert all(torch.equal(r, router[i % L]) for i, (r, _) in enumerate(seen))
    rows = ~(near_ties(cfg, seen[:L])[:, -1] | near_ties(cfg, seen[L:])[:, 0])
    assert rows.any()
    close(logits[rows], np.asarray(jlogits)[rows.numpy()], TOL_BF16)
    close(l2[rows], np.asarray(jl2)[rows.numpy()], TOL_BF16)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_moe_tree_bf16(arch):
    """A bf16 JAX tree with its f32 routers loads bit for bit."""
    jparams = to_numpy(jax_get_model(jax_smoke_config(arch)).init(jax.random.PRNGKey(3)))
    model = get_model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0),
                                                   device="cpu")
    load_jax_params(model, jparams)
    got = {n: p.detach() for n, p in model.named_parameters()}
    flat = flatten(jparams)
    assert sorted(got) == sorted(flat)
    for name, arr in flat.items():
        if name == "blocks.moe.router":
            assert arr.dtype == np.float32 and got[name].dtype == torch.float32
            np.testing.assert_array_equal(got[name].numpy(), arr)
        else:
            assert arr.dtype == ml_dtypes.bfloat16, name
            back = got[name].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_shapes_and_scales(arch):
    _, cfg = configs(arch)
    cfg = cfg.replace(d_model=256, d_ff=512)
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jcfg = jax_smoke_config(arch).replace(dtype="float32", d_model=256, d_ff=512)
    flat = flatten(to_numpy(jax_get_model(jcfg).init(jax.random.PRNGKey(0))))
    for name, p in model.named_parameters():
        assert tuple(p.shape) == flat[name].shape, name
        want = float(np.std(flat[name]))
        tol = 0.1 if name == "blocks.moe.router" else 0.05  # 2 x 256 x 4 router draws
        assert abs(float(p.std()) - want) <= tol * want + 1e-6, name


def test_launcher_on_cpu(capsys):
    serve.main(["--arch", "grok_1_314b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=grok-1-314b" in out and "generated=3 tokens/request" in out
