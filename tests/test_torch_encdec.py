"""The port's encoder-decoder against the JAX package.

On the smoke config of ``seamless_m4t_large_v2`` (2 + 2 layers, an
``enc_emb`` stub of 32 frames), in f32: ``encode``, ``cross_attn_apply``,
``apply``, ``prefill`` (logits, the zero-padded self-attention caches and
the precomputed cross-attention K/V) and ``decode_step``, from the port's
own state and from JAX's state bridged through ``state_from_jax``; Engine
greedy tokens against the JAX Engine on the same ``enc_emb``.  All at 2e-3,
the model-level tolerance of tests/models/test_smoke.py; one bf16 case at
2e-2, as tests/test_torch_lm.py states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.serve import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import EncDecLM, get_model
from repro_torch.models import layers as tlayers
from repro_torch.serve import Engine, make_decode_step, make_prefill_step
from repro_torch.weights import flatten, load_jax_params, state_from_jax

TOL = 2e-3
TOL_BF16 = 2e-2
ARCH = "seamless_m4t_large_v2"
B, S, MAX_LEN = 2, 12, 16


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def bridged(dtype="float32", seed=0):
    """(JAX model, JAX params, port model with the same weights, tokens,
    enc_emb), the inputs numpy-seeded; enc_emb in the model's type."""
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = get_model(get_smoke_config(ARCH).replace(dtype=dtype)).init(
        torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, to_numpy(jparams))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    enc_emb = rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)).astype(np.float32)
    return jmodel, jparams, model, tokens, enc_emb


def batches(tokens, enc_emb, dtype=torch.float32):
    """The same batch for JAX and for the port."""
    emb = torch.from_numpy(enc_emb).to(dtype)
    jemb = jnp.asarray(emb.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                   else jnp.float32)
    return ({"tokens": jnp.asarray(tokens), "enc_emb": jemb},
            {"tokens": torch.from_numpy(tokens), "enc_emb": emb})


def test_get_model_and_param_names():
    jparams = to_numpy(jax_get_model(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0)))
    model = get_model(get_smoke_config(ARCH))
    assert isinstance(model, EncDecLM)
    params = dict(model.named_parameters())
    flat = flatten(jparams)
    assert sorted(params) == sorted(flat)
    for name, arr in flat.items():
        assert tuple(params[name].shape) == arr.shape, name
        assert params[name].dtype == torch.bfloat16, name


def test_encode():
    jmodel, jparams, model, _, enc_emb = bridged()
    want = jmodel.encode(jparams, jnp.asarray(enc_emb), remat=False)
    close(model.encode(torch.from_numpy(enc_emb)), want)


def test_cross_attn_apply():
    """Queries from x, K/V from a memory of another length; no RoPE."""
    jmodel, jparams, model, _, _ = bridged()
    cfg = model.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    memory = rng.standard_normal((B, 23, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"]["xattn"])
    want = jlayers.cross_attn_apply(jmodel.cfg, jp, jnp.asarray(x), jnp.asarray(memory))
    got = tlayers.cross_attn_apply(cfg, model.dec_blocks.layers()[0]["xattn"],
                                   torch.from_numpy(x), torch.from_numpy(memory))
    close(got, want)


def test_apply():
    jmodel, jparams, model, tokens, enc_emb = bridged()
    jb, tb = batches(tokens, enc_emb)
    got = model.apply(tb)
    assert got.shape == (B, S, model.cfg.vocab) and got.dtype == torch.float32
    close(got, jmodel.apply(jparams, jb))
    hidden, aux = model.hidden_states(tb, with_aux=True)
    assert aux == {} and hidden.shape == (B, S, model.cfg.d_model)


def test_prefill_then_decode():
    jmodel, jparams, model, tokens, enc_emb = bridged()
    jmem = jmodel.encode(jparams, jnp.asarray(enc_emb), remat=False)
    mem = model.encode(torch.from_numpy(enc_emb))
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), jmem, max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), mem, max_len=MAX_LEN)
    assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
    close(logits, jlogits)
    assert sorted(state) == sorted(jstate) == ["kv", "pos", "xk", "xv"]
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [S] * B
    for got, want in zip(state["kv"], jstate["kv"]):
        assert tuple(got.shape) == want.shape
        close(got, want)
        assert not got[:, :, S:].any()  # zero past the prompt
    for name in ("xk", "xv"):
        assert tuple(state[name].shape) == jstate[name].shape
        close(state[name], jstate[name])

    nxt = np.array([[3], [7]], np.int32)
    jl2, jstate2 = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    # from JAX's own state, bridged (before the port's state is updated in place)
    l3, _ = model.decode_step(state_from_jax(to_numpy(jstate), device="cpu"),
                              torch.from_numpy(nxt))
    close(l3, jl2)
    l2, state2 = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2)
    close(state2["kv"][0], jstate2["kv"][0])
    assert state2["pos"].tolist() == [S + 1] * B


def test_bf16_prefill_and_decode():
    jmodel, jparams, model, tokens, enc_emb = bridged(dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    jb, tb = batches(tokens, enc_emb, torch.bfloat16)
    close(model.apply(tb), jmodel.apply(jparams, jb), TOL_BF16)
    jmem = jmodel.encode(jparams, jb["enc_emb"], remat=False)
    mem = model.encode(tb["enc_emb"])
    jlogits, jstate = jmodel.prefill(jparams, jb["tokens"], jmem, max_len=MAX_LEN)
    logits, state = model.prefill(tb["tokens"], mem, max_len=MAX_LEN)
    close(logits, jlogits, TOL_BF16)
    nxt = np.array([[5], [1]], np.int32)
    jl2, _ = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l2, _ = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2, TOL_BF16)


def test_greedy_tokens_match_jax_engine():
    jmodel, jparams, model, tokens, enc_emb = bridged()
    jb, tb = batches(tokens, enc_emb)
    want = JaxEngine(jmodel.cfg, jparams, max_len=24).generate(jb, 6)
    got = Engine(model, max_len=24, device="cpu").generate(tb, 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_prefill_matches_stepwise_decode():
    """As tests/serve/test_engine.py checks the JAX engine: the prefill step
    (encoder, then the decoder's prefill) lands in the state that stepping
    token by token from ``decode_init`` reaches."""
    _, _, model, tokens, enc_emb = bridged()
    _, tb = batches(tokens, enc_emb)
    logits_p, state_p = make_prefill_step(model, max_len=S + 4)(tb)
    decode = make_decode_step(model)
    state = model.decode_init(B, S + 4, model.encode(tb["enc_emb"]))
    for t in range(S):
        logits_s, state = decode(state, tb["tokens"][:, t : t + 1])
    close(logits_p[:, 0], logits_s[:, 0].numpy())
    nxt = torch.argmax(logits_p[:, -1], dim=-1)[:, None]
    a, _ = decode(state_p, nxt)
    b, _ = decode(state, nxt)
    close(a, b.numpy())


def test_state_bridge_checks_the_cross_kv():
    _, _, model, tokens, enc_emb = bridged()
    _, state = model.prefill(torch.from_numpy(tokens), model.encode(torch.from_numpy(enc_emb)),
                             max_len=MAX_LEN)
    tree = {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy())
            for k, v in state.items()}
    assert sorted(state_from_jax(tree, device="cpu")) == ["kv", "pos", "xk", "xv"]
    with pytest.raises(ValueError, match="cross KV"):
        state_from_jax(dict(tree, xk=tree["xk"][:, :1], xv=tree["xv"][:, :1]), device="cpu")
    with pytest.raises(KeyError):
        state_from_jax({k: v for k, v in tree.items() if k != "xv"}, device="cpu")


def test_init_shapes_and_scales():
    cfg = get_smoke_config(ARCH).replace(dtype="float32", d_model=256, d_ff=512)
    model = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32", d_model=256, d_ff=512)
    flat = flatten(to_numpy(jax_get_model(jcfg).init(jax.random.PRNGKey(0))))
    for name, p in model.named_parameters():
        assert tuple(p.shape) == flat[name].shape, name
        want = float(np.std(flat[name]))
        assert abs(float(p.std()) - want) <= 0.05 * want + 1e-6, name


def test_launcher_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-large-v2" in out and "generated=3 tokens/request" in out
