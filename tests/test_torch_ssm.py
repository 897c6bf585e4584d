"""The port's Mamba-2 block and SSM/hybrid LM against the JAX package.

On the smoke configs of ``mamba2_2p7b`` and ``zamba2_1p2b``, in f32, with
prompts of 32 tokens (two chunks of the smoke chunk 16, so the inter-chunk
recurrence runs): ``mamba_apply`` (with its conv tail) and
``mamba_decode_step``; ``LM.apply``; ``prefill`` (logits, every SSM state
tensor and the hybrid's shared-block caches); ``decode_step`` from the
port's own state and from JAX's state bridged through ``state_from_jax``.
All at 2e-3, the model-level tolerance of tests/models/test_smoke.py.  Also
one bf16 case, the param types, and the prompt-length check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import mamba2 as jm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import mamba2 as tm
from repro_torch.weights import flatten, load_jax_params, state_from_jax, to_tensor

TOL = 2e-3
# bf16: the packages round at the same points (the conv taps, x * dt, the D
# skip, the decode's outer product), but not alike inside them: XLA's CPU
# silu rounds exp, 1 + exp, the reciprocal and the product each to bf16,
# torch's fused silu once, so ~40% of the silu outputs differ by one bf16
# step; and the matmuls sum in other orders.  The SSM state carries each
# such step to every later position, so the logits differ by an error RMS
# of 1-2.8% of their RMS (max abs 0.027 at logits of std 0.16, measured on
# these inputs); 5e-2 is about twice the largest.
TOL_BF16 = 5e-2
SSM_ARCHS = ["mamba2_2p7b", "zamba2_1p2b"]
B, S, MAX_LEN = 2, 32, 40


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def bridged(arch, dtype="float32", seed=0):
    """(JAX model, JAX params, port model with the same weights, tokens)."""
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = get_model(get_smoke_config(arch).replace(dtype=dtype)).init(
        torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, to_numpy(jparams))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jmodel, jparams, model, tokens


def layer0(jparams, model):
    """Layer 0's Mamba params: (JAX tree, the port's dict)."""
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["mamba"])
    return jp, model.blocks.layers()[0]["mamba"]


def rand(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
def test_mamba_apply(arch, with_h0):
    jmodel, jparams, model, _ = bridged(arch)
    cfg = model.cfg
    jp, p = layer0(jparams, model)
    rng = np.random.default_rng(1)
    jx, x = rand(rng, (B, S, cfg.d_model))
    jh0, h0 = rand(rng, (B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), 0.5)
    if not with_h0:
        jh0, h0 = None, None
    want = jm.mamba_apply(jmodel.cfg, jp, jx, jh0, return_conv_tail=True)
    got = tm.mamba_apply(cfg, p, x, h0, return_conv_tail=True)
    assert got[1].dtype == torch.float32
    assert got[2].shape == (B, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_decode_step(arch):
    jmodel, jparams, model, _ = bridged(arch)
    cfg = model.cfg
    jp, p = layer0(jparams, model)
    rng = np.random.default_rng(2)
    jx, x = rand(rng, (B, 1, cfg.d_model))
    jh, h = rand(rng, (B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), 0.5)
    jc, c = rand(rng, (B, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state))
    want_y, want_state = jm.mamba_decode_step(jmodel.cfg, jp, jx, {"h": jh, "conv": jc})
    got_y, got_state = tm.mamba_decode_step(cfg, p, x, {"h": h, "conv": c})
    close(got_y, want_y)
    close(got_state["h"], want_state["h"])
    close(got_state["conv"], want_state["conv"])


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
@pytest.mark.parametrize("Sn", [64, 12, 1])  # whole chunks of 16; shorter than one
def test_ssd_chunked_matches_jax(with_h0, Sn):
    rng = np.random.default_rng(3)
    Bn, nh, hd, N = 2, 3, 16, 8
    jx, x = rand(rng, (Bn, Sn, nh, hd))
    a_np = (-np.abs(rng.standard_normal((Bn, Sn, nh))) * 0.1).astype(np.float32)
    ja, a = jnp.asarray(a_np), torch.from_numpy(a_np)
    jb, b = rand(rng, (Bn, Sn, N), 0.3)
    jc, c = rand(rng, (Bn, Sn, N), 0.3)
    jh0, h0 = rand(rng, (Bn, nh, hd, N), 0.5) if with_h0 else (None, None)
    wy, wh = jm.ssd_chunked(jx, ja, jb, jc, 16, jh0)
    gy, gh = tm.ssd_chunked(x, a, b, c, 16, h0)
    close(gy, wy, 2e-4)
    close(gh, wh, 2e-4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_apply(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    close(model.apply(torch.from_numpy(tokens)), jmodel.apply(jparams, jnp.asarray(tokens)))


def assert_state_close(state, jstate, tol=TOL):
    close(state["ssm"]["h"], jstate["ssm"]["h"], tol)
    close(state["ssm"]["conv"], jstate["ssm"]["conv"], tol)
    assert state["ssm"]["h"].dtype == torch.float32
    assert ("shared_kv" in state) == ("shared_kv" in jstate)
    if "shared_kv" in jstate:
        for got, want in zip(state["shared_kv"], jstate["shared_kv"]):
            assert tuple(got.shape) == want.shape
            close(got, want, tol)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_then_decode(arch):
    jmodel, jparams, model, tokens = bridged(arch)
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
    close(logits, jlogits)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [S] * B
    assert_state_close(state, jstate)
    if "shared_kv" in state:
        n_calls = model.cfg.n_layers // model.cfg.hybrid_period
        assert state["shared_kv"][0].shape[0] == n_calls
        assert not state["shared_kv"][0][:, :, S:].any()  # zero past the prompt

    nxt = np.array([[3], [7]], np.int32)
    jl2, jstate2 = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    # from JAX's own state, bridged (before the port's state is updated in place)
    l3, state3 = model.decode_step(state_from_jax(to_numpy(jstate), device="cpu"),
                                   torch.from_numpy(nxt))
    close(l3, jl2)
    assert_state_close(state3, jstate2)
    l2, state2 = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2)
    assert_state_close(state2, jstate2)
    assert state2["pos"].tolist() == [S + 1] * B


def test_bf16_prefill_and_decode():
    jmodel, jparams, model, tokens = bridged("zamba2_1p2b", dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks.mamba["A_log"].dtype == torch.float32
    jlogits, jstate = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=MAX_LEN)
    logits, state = model.prefill(torch.from_numpy(tokens), max_len=MAX_LEN)
    close(logits, jlogits, TOL_BF16)
    nxt = np.array([[5], [1]], np.int32)
    jl2, _ = jmodel.decode_step(jparams, jstate, jnp.asarray(nxt))
    l2, _ = model.decode_step(state, torch.from_numpy(nxt))
    close(l2, jl2, TOL_BF16)
    close(model.apply(torch.from_numpy(tokens)), jmodel.apply(jparams, jnp.asarray(tokens)),
          TOL_BF16)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_names_shapes_and_types(arch):
    """The port's params are JAX's tree, key for key, shape for shape and
    type for type, in bf16 too: A_log, D and dt_bias stay f32."""
    jparams = to_numpy(jax_get_model(jax_smoke_config(arch)).init(jax.random.PRNGKey(0)))
    model = get_model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0),
                                                   device="cpu")
    flat = flatten(jparams)
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(flat)
    for name, arr in flat.items():
        ref = to_tensor(arr)
        assert params[name].shape == ref.shape and params[name].dtype == ref.dtype, name
    for name in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(params[f"blocks.mamba.{name}"].numpy(),
                                   flat[f"blocks.mamba.{name}"], rtol=1e-6)


@pytest.mark.parametrize("S,Q", [(1, 1), (12, 12), (16, 16), (48, 16), (0, None),
                                 (20, None), (33, None)])
def test_chunk_len(S, Q):
    """The one rule for the SSD's sequence lengths, with chunk 16."""
    if Q is None:
        with pytest.raises(ValueError, match="multiple of it"):
            kops.chunk_len(S, 16)
    else:
        assert kops.chunk_len(S, 16) == Q


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prompt_length_must_fit_the_chunks(arch, capsys):
    model = get_model(get_smoke_config(arch).replace(dtype="float32")).init(
        torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="multiple of it"):
        model.prefill(torch.zeros(1, 20, dtype=torch.long), max_len=24)
    model.prefill(torch.zeros(1, 12, dtype=torch.long), max_len=16)  # under one chunk
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "20"])
    assert "multiple of it" in capsys.readouterr().err
