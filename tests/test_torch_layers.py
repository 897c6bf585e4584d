"""Each ported function of models/layers.py against its JAX twin.

The same inputs, made with numpy from a seed, go through both packages; the
cases are those of tests/models/test_layers.py.  f32 throughout, at 1e-5
where the math is elementwise and 2e-4 where a contraction's summation
order differs between the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig
from repro_torch.weights import to_tensor


def cfgs(**kw):
    d = dict(arch_id="t", family="dense", n_layers=2, d_model=64, vocab=128,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
    d.update(kw)
    return JaxModelConfig(**d), ModelConfig(**d)


def pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(got: torch.Tensor, want, tol=2e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def bridge(tree):
    return {k: to_tensor(np.asarray(v)) for k, v in tree.items()}


class TestElementary:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rms_norm(self, dtype):
        rng = np.random.default_rng(0)
        jx, tx = pair(rng, (4, 64), 7.0)
        js, ts = pair(rng, (64,), 0.1)
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        got = tl.rms_norm(tx.to(td), ts.to(td))
        want = jl.rms_norm(jx.astype(jd), js.astype(jd))
        assert got.dtype == td
        close(got, want, 1e-5 if dtype == "float32" else 1e-2)

    def test_softcap(self):
        jx, tx = pair(np.random.default_rng(1), (64,), 100.0)
        close(tl.softcap(tx, 30.0), jl.softcap(jx, 30.0), 1e-5)
        assert tl.softcap(tx, None) is tx

    @pytest.mark.parametrize("name", ["silu", "gelu"])
    def test_activation(self, name):
        jx, tx = pair(np.random.default_rng(2), (256,), 3.0)
        close(tl.activation_fn(name)(tx), jl.activation_fn(name)(jx), 1e-5)

    @pytest.mark.parametrize("hd,theta", [(16, 1e4), (160, 1e4), (64, 1e6)])
    def test_rope(self, hd, theta):
        rng = np.random.default_rng(3)
        jx, tx = pair(rng, (2, 8, 4, hd))
        pos = np.stack([np.arange(8), np.arange(100, 108)]).astype(np.int32)
        got = tl.rope(tx, torch.from_numpy(pos), theta)
        close(got, jl.rope(jx, jnp.asarray(pos), theta), 1e-4)


class TestAttention:
    @pytest.mark.parametrize("window,local", [(None, False), (8, True), (8, False)])
    def test_naive_and_chunked(self, window, local):
        jc, tc = cfgs(sliding_window=window, attn_q_chunk=8, local_count=1 if local else 0)
        rng = np.random.default_rng(4)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s) for s in
                                     [(2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)])
        want = jl.attention_naive(jq, jk, jv, cfg=jc, is_local=local)
        close(tl.attention_naive(q, k, v, cfg=tc, is_local=local), want)
        close(tl.attention_chunked(q, k, v, cfg=tc, is_local=local),
              jl.attention_chunked(jq, jk, jv, cfg=jc, is_local=local))

    def test_softcap_and_offset(self):
        jc, tc = cfgs(attn_logit_softcap=20.0, attn_q_chunk=8)
        rng = np.random.default_rng(5)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s, 3.0) for s in
                                     [(1, 16, 4, 16), (1, 24, 2, 16), (1, 24, 2, 16)])
        close(tl.attention_naive(q, k, v, cfg=tc, q_offset=8),
              jl.attention_naive(jq, jk, jv, cfg=jc, q_offset=8))
        close(tl.attention_chunked(q, k, v, cfg=tc, q_offset=8),
              jl.attention_chunked(jq, jk, jv, cfg=jc, q_offset=8))

    @pytest.mark.parametrize("Sq", [8, 48])  # auto: naive, then chunked
    def test_dispatch_auto_on_cpu(self, Sq):
        jc, tc = cfgs(attn_q_chunk=8, sliding_window=4, local_count=1)
        rng = np.random.default_rng(6)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s) for s in
                                     [(2, Sq, 4, 16), (2, Sq, 2, 16), (2, Sq, 2, 16)])
        close(tl.attention(q, k, v, cfg=tc, is_local=True),
              jl.attention(jq, jk, jv, cfg=jc, is_local=True))

    @pytest.mark.parametrize("window,local,cap", [(None, False, None), (4, True, 30.0)])
    def test_decode(self, window, local, cap):
        jc, tc = cfgs(sliding_window=window, local_count=1 if local else 0,
                      attn_logit_softcap=cap)
        rng = np.random.default_rng(7)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s) for s in
                                     [(2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)])
        pos = np.array([5, 12], np.int32)
        close(tl.attention_decode(q, k, v, torch.from_numpy(pos), cfg=tc, is_local=local),
              jl.attention_decode(jq, jk, jv, jnp.asarray(pos), cfg=jc, is_local=local))


class TestBlocks:
    @pytest.mark.parametrize("kw", [dict(), dict(qk_norm=True, rope_theta=1e6)],
                             ids=["plain", "qk_norm"])
    def test_attn_apply_and_qkv(self, kw):
        jc, tc = cfgs(**kw)
        jp = jl.attn_init(jc, jax.random.PRNGKey(0), jnp.float32)
        if "q_norm" in jp:  # nonzero norms, so the branch matters
            jp = {**jp, "q_norm": jp["q_norm"] + 0.3, "k_norm": jp["k_norm"] - 0.2}
        tp = bridge(jp)
        jx, tx = pair(np.random.default_rng(8), (2, 10, 64))
        pos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
        for got, want in zip(tl.attn_qkv(tc, tp, tx, torch.from_numpy(pos)),
                             jl.attn_qkv(jc, jp, jx, jnp.asarray(pos))):
            close(got, want)
        y, (k, v) = tl.attn_apply(tc, tp, tx, return_kv=True)
        wy, (wk, wv) = jl.attn_apply(jc, jp, jx, return_kv=True)
        close(y, wy)
        close(k, wk)
        close(v, wv)

    def test_attn_decode_apply_writes_cache_in_place(self):
        jc, tc = cfgs()
        jp = jl.attn_init(jc, jax.random.PRNGKey(1), jnp.float32)
        tp = bridge(jp)
        rng = np.random.default_rng(9)
        jx, tx = pair(rng, (2, 1, 64))
        (jk, tk), (jv, tv) = pair(rng, (2, 16, 2, 16)), pair(rng, (2, 16, 2, 16))
        pos = np.array([3, 9], np.int32)
        y, (k_out, v_out) = tl.attn_decode_apply(tc, tp, tx, (tk, tv), torch.from_numpy(pos))
        wy, (wk, wv) = jl.attn_decode_apply(jc, jp, jx, (jk, jv), jnp.asarray(pos))
        assert k_out is tk and v_out is tv
        close(y, wy)
        close(tk, wk)
        close(tv, wv)

    @pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"), (True, "gelu")])
    def test_mlp_apply(self, gated, act):
        jc, tc = cfgs(mlp_gated=gated, activation=act)
        jp = jl.mlp_init(jc, jax.random.PRNGKey(2), jnp.float32)
        jx, tx = pair(np.random.default_rng(10), (2, 5, 64))
        close(tl.mlp_apply(tc, bridge(jp), tx), jl.mlp_apply(jc, jp, jx))

    @pytest.mark.parametrize("qk_norm,gated", [(False, True), (True, False)])
    def test_init_shapes_and_scales(self, qk_norm, gated):
        jc, tc = cfgs(d_model=256, d_ff=512, qk_norm=qk_norm, mlp_gated=gated)
        g = torch.Generator().manual_seed(0)
        for jfn, tfn in [(jl.attn_init, tl.attn_init), (jl.mlp_init, tl.mlp_init)]:
            jp = jfn(jc, jax.random.PRNGKey(0), jnp.float32)
            tp = tfn(tc, g, torch.float32, "cpu")
            assert {k: tuple(v.shape) for k, v in tp.items()} == \
                   {k: tuple(v.shape) for k, v in jp.items()}
            for name, w in tp.items():
                want = float(np.std(np.asarray(jp[name])))
                assert abs(float(w.std()) - want) <= 0.05 * want + 1e-6, name
