"""The port's kernels' plain versions and ``ops`` against the JAX package.

On the CPU the plain versions (``repro_torch.kernels.ref``) are held against
JAX's ``kernels/ref.py`` and against the Pallas kernels run in interpret
mode, over the shape sweeps of tests/kernels/test_kernels.py plus the head
size 160 of stablelm-12b, ragged lengths (which Pallas cannot tile, so
those go against ``ref.py`` only) and the SSD chunk of the full Mamba-2
configs (Q=256, hd=64, N=128).  The ``ops`` wrappers, in the model's
layout, are held against ``repro.kernels.ops`` (attention with
``use_pallas=False``; the SSD with the Pallas kernel in interpret mode) and
``ops.ssd`` also against ``repro.models.mamba2.ssd_chunked``.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.

Tolerances as tests/kernels/test_kernels.py: f32 2e-4, bf16 3e-2.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_bkh
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.ssd_scan import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as dec

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def assert_close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(
        got.float().cpu().numpy(), np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype]
    )


# (B, H, K, Sq, Sk, hd, bq, bk); bq/bk = None: lengths Pallas cannot tile.
FLASH_SHAPES = [
    (2, 4, 2, 256, 256, 64, 128, 128),
    (1, 8, 8, 128, 128, 32, 64, 64),  # MHA
    (1, 8, 2, 128, 256, 64, 128, 128),  # cross-ish lengths
    (2, 6, 2, 192, 192, 64, 64, 64),  # non-square blocks
    (1, 4, 1, 128, 128, 160, 64, 64),  # stablelm-12b head size
    (2, 4, 2, 100, 100, 160, None, None),  # ragged S
]


class TestFlashAttentionRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,Sq,Sk,hd,bq,bk", FLASH_SHAPES)
    def test_matches_jax(self, dtype, B, H, K, Sq, Sk, hd, bq, bk):
        rng = np.random.default_rng(0)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s, dtype) for s in
                                     [(B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)])
        scale = hd ** -0.5
        got = ref.flash_attention_ref(q, k, v, scale=scale, causal=True)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert_close(got, jref.flash_attention_ref(jq, jk, jv, scale=scale, causal=True), dtype)
        if bq is not None:
            pallas = flash_attention_bhsd(jq, jk, jv, scale=scale, causal=True,
                                          block_q=bq, block_k=bk)
            assert_close(got, pallas, dtype)

    @pytest.mark.parametrize(
        "kw", [dict(window=32), dict(window=128), dict(softcap=20.0), dict(causal=False),
               dict(window=64, softcap=30.0)],
        ids=["window32", "window128", "softcap", "non_causal", "window_softcap"],
    )
    def test_mask_and_softcap(self, kw):
        rng = np.random.default_rng(1)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s, "float32") for s in
                                     [(1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)])
        q, jq = q * 4, jq * 4
        got = ref.flash_attention_ref(q, k, v, scale=0.125, **kw)
        assert_close(got, jref.flash_attention_ref(jq, jk, jv, scale=0.125, **kw), "float32")
        pallas = flash_attention_bhsd(jq, jk, jv, scale=0.125, block_q=64, block_k=64, **kw)
        assert_close(got, pallas, "float32")


# (B, H, K, S, hd, bk); bk = None: a cache length Pallas cannot tile.
DECODE_SHAPES = [
    (2, 4, 2, 512, 64, 128),
    (4, 8, 8, 256, 32, 64),
    (1, 16, 2, 1024, 64, 256),
    (2, 8, 2, 256, 160, 128),  # stablelm-12b head size
    (4, 8, 2, 545, 160, None),  # the Engine's max_len = prompt + gen + 1
]


class TestDecodeAttentionRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,H,K,S,hd,bk", DECODE_SHAPES)
    def test_matches_jax(self, dtype, B, H, K, S, hd, bk):
        rng = np.random.default_rng(2)
        (jq, q), (jk, kc), (jv, vc) = (pair(rng, s, dtype) for s in
                                       [(B, H, hd), (B, K, S, hd), (B, K, S, hd)])
        lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
        scale = hd ** -0.5
        got = ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths), scale=scale)
        want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths), scale=scale)
        assert_close(got, want, dtype)
        if bk is not None:
            pallas = decode_attention_bkh(jq, jk, jv, jnp.asarray(lengths), scale=scale,
                                          block_k=bk)
            assert_close(got, pallas, dtype)

    @pytest.mark.parametrize("kw", [dict(window=128), dict(window=100, softcap=50.0)],
                             ids=["window", "window_softcap"])
    def test_window_and_softcap(self, kw):
        rng = np.random.default_rng(3)
        (jq, q), (jk, kc), (jv, vc) = (pair(rng, s, "float32") for s in
                                       [(2, 4, 32), (2, 4, 512, 32), (2, 4, 512, 32)])
        lengths = np.array([400, 512], np.int32)
        got = ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths), scale=32 ** -0.5, **kw)
        want = decode_attention_bkh(jq, jk, jv, jnp.asarray(lengths), scale=32 ** -0.5,
                                    block_k=128, **kw)
        assert_close(got, want, "float32")


def h100_resident(cluster, heads):
    """A model of the card's occupancy for the CPU tests: 132 SMs, two
    blocks each, clusters packed without loss (on the card the plan asks
    the CUDA occupancy calculator)."""
    return 2 * 132 // cluster


def check_plan(B, K, R, S, hd, window, f32):
    """The plan's invariants for one call: a cluster within the launcher's
    limit that the card holds all of (or of one block), head groups that
    cover the q_per_kv heads with none empty, the kernel's tile, and every
    key of [len - window, len) in exactly one split, for every length
    1..S."""
    p = dec.plan(B, K, R, S, hd, window, h100_resident, f32=f32)
    assert 1 <= p.cluster <= dec.MAX_CLUSTER
    assert p.cluster == 1 or B * K * p.groups <= h100_resident(p.cluster, p.heads)
    assert p.heads <= dec.MAX_HEADS and (p.groups - 1) * p.heads < R <= p.groups * p.heads
    assert p.tile == dec.tile_keys(hd, f32)
    for length in range(1, S + 1):
        first = max(0, length - window) if window else 0
        splits = [dec.split_keys(p, length, window, rank) for rank in range(p.cluster)]
        covered = [s for s in splits if len(s)]
        assert covered[0].start == first and covered[-1].stop == length
        assert all(a.stop == b.start for a, b in zip(covered, covered[1:]))
        assert sum(len(s) for s in splits) == length - first
    return p


# Sequence shards of a decode cache: (shards, S, lengths, window, softcap).
# S is cut into equal shards; lengths at a shard's edge (a multiple of
# S / shards), one short of it and one past it, a row of length 1 (every
# shard but the first empty), the whole cache; windows that cross shard
# edges and leave the first shards empty.
SHARD_CASES = [
    (1, 40, [40, 17, 1], None, None),
    (2, 40, [20, 21, 19, 1], None, None),
    (5, 40, [16, 24, 40, 1, 9], 9, None),
    (8, 40, [5, 10, 38, 1, 40], 7, 50.0),
    (8, 24, [24, 13, 3, 16], 8, 50.0),
    (5, 40, [40, 33, 8, 2], None, 30.0),
]


def shards_of(S, n):
    return [(i * (S // n), (i + 1) * (S // n)) for i in range(n)]


class TestDecodeShards:
    """The plain decode attention on sequence shards of a cache (a mesh's
    ranks' shards): each shard's output and log-sum-exp with its keys'
    global offset, merged by ``ops.merge_decode_partials``, equal the
    whole-cache call; a shard with no valid key gives output 0 and
    log-sum-exp -inf, exactly 0 weight."""

    @staticmethod
    def inputs(dtype, S, lengths, seed=9):
        rng = np.random.default_rng(seed)
        B = len(lengths)
        (_, q), (_, kc), (_, vc) = (pair(rng, s, dtype) for s in
                                    [(B, 1, 8, 16), (B, S, 2, 16), (B, S, 2, 16)])
        return q, kc, vc, torch.tensor(lengths, dtype=torch.int32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,S,lengths,window,cap", SHARD_CASES)
    def test_merged_shards_equal_the_whole_cache(self, dtype, n, S, lengths, window, cap):
        q, kc, vc, lens = self.inputs(dtype, S, lengths)
        kw = dict(scale=0.25, window=window, softcap=cap)
        whole = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                         **kw)
        outs, lses = [], []
        for lo, hi in shards_of(S, n):
            o, lse = ref.decode_attention_ref(
                q[:, 0], kc[:, lo:hi].transpose(1, 2), vc[:, lo:hi].transpose(1, 2), lens,
                key_offset=lo, return_lse=True, **kw)
            assert lse.dtype == torch.float32 and lse.shape == (len(lengths), 8)
            first = np.maximum(0, np.array(lengths) - window) if window else 0
            empty = torch.from_numpy((np.array(lengths) <= lo) | (first >= hi))
            assert torch.isneginf(lse[empty]).all() and torch.isfinite(lse[~empty]).all()
            assert (o[empty] == 0).all()
            outs.append(o)
            lses.append(lse)
        merged = ops.merge_decode_partials(outs, lses)
        assert merged.dtype == q.dtype and torch.isfinite(merged.float()).all()
        # bf16: each shard's output rounds to bf16 before the merge, one more
        # rounding than the whole call's: within TOL.
        assert_close(merged, whole.float().numpy(), dtype)

    @pytest.mark.parametrize("n,S,lengths,window,cap", SHARD_CASES)
    def test_through_ops_and_a_row_offset(self, n, S, lengths, window, cap):
        """``ops.decode_attention`` in the model's layout, its offset a (B,)
        tensor; its log-sum-exp is that of the shard's logits."""
        q, kc, vc, lens = self.inputs("float32", S, lengths, seed=10)
        kw = dict(scale=0.25, window=window, softcap=cap)
        whole = ops.decode_attention(q, kc, vc, lens, **kw)
        parts = [ops.decode_attention(q, kc[:, lo:hi], vc[:, lo:hi], lens, return_lse=True,
                                      key_offset=torch.full((len(lengths),), lo), **kw)
                 for lo, hi in shards_of(S, n)]
        assert all(o.shape == q.shape for o, _ in parts)
        merged = ops.merge_decode_partials([o for o, _ in parts], [lse for _, lse in parts])
        assert_close(merged, whole.numpy(), "float32")
        # The whole cache's log-sum-exp from its logits, the shards' combined.
        s = torch.einsum("bkrd,bksd->bkrs", q[:, 0].reshape(len(lengths), 2, 4, 16),
                         kc.transpose(1, 2)) * 0.25
        if cap:
            s = cap * torch.tanh(s / cap)
        kp = torch.arange(S)
        ok = kp[None] < lens[:, None]
        if window:
            ok &= kp[None] >= lens[:, None] - window
        want = torch.logsumexp(torch.where(ok[:, None, None], s, -torch.inf), -1)
        got = torch.logsumexp(torch.stack([lse for _, lse in parts]), 0)
        np.testing.assert_allclose(got.numpy(), want.reshape(got.shape).numpy(), rtol=1e-5)

    def test_without_the_new_operands_as_before(self):
        """With neither operand a row with no valid key still gets the mean
        of V, as the JAX reference gives it."""
        q, kc, vc, _ = self.inputs("float32", 8, [1])
        out = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
                                       torch.tensor([0]), scale=0.25)
        np.testing.assert_allclose(out.numpy(), vc.mean(1).repeat_interleave(4, 1).numpy(),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("n,S,lengths,window,cap", SHARD_CASES[:4])
    def test_model_plain_path_on_shards(self, n, S, lengths, window, cap):
        """The model's plain ``attention_decode`` (JAX's rounding) on shards,
        merged, equals its whole-cache call."""
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.layers import attention_decode

        cfg = get_smoke_config("gemma2_2b").replace(
            dtype="float32", n_heads=8, n_kv_heads=2, head_dim=16, sliding_window=window,
            attn_logit_softcap=cap)
        q, kc, vc, lens = self.inputs("float32", S, lengths, seed=11)
        whole = attention_decode(q, kc, vc, lens, cfg=cfg, is_local=True)
        parts = [attention_decode(q, kc[:, lo:hi], vc[:, lo:hi], lens, cfg=cfg, is_local=True,
                                  key_offset=lo, return_lse=True) for lo, hi in shards_of(S, n)]
        merged = ops.merge_decode_partials([o for o, _ in parts], [lse for _, lse in parts])
        np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)


class TestDecodePlan:
    """The split plan of the decode kernel (pure Python)."""

    @pytest.mark.parametrize("f32", [False, True])
    @pytest.mark.parametrize("B,K,R,S,hd,window", [
        (4, 8, 4, 545, 160, None),  # stablelm-12b's decode
        (4, 32, 1, 1057, 64, None),  # zamba2-1.2b's
        (1, 1, 4, 4096, 64, None),  # one pair: the largest cluster
        (64, 32, 1, 4096, 128, None),  # many pairs: no split
        (1, 2, 12, 4096, 256, 1000),
        (3, 5, 5, 77, 16, 40),
        (64, 1, 8, 1, 32, None),
        (2, 4, 130, 300, 160, 128),
        (7, 3, 2, 2049, 64, 4096),
    ])
    def test_every_key_in_one_split(self, B, K, R, S, hd, window, f32):
        check_plan(B, K, R, S, hd, window, f32)

    def test_random_calls(self):
        rng = np.random.default_rng(7)
        for _ in range(60):
            B, K, S = int(rng.integers(1, 65)), int(rng.integers(1, 33)), int(rng.integers(1, 4097))
            window = None if rng.random() < 0.5 else int(rng.integers(1, 5000))
            hd = int(rng.choice([16, 32, 64, 128, 160, 256]))
            check_plan(B, K, int(rng.integers(1, 17)), S, hd, window, bool(rng.random() < 0.3))

    @pytest.mark.parametrize("B,K,R,S,hd", [(4, 8, 4, 545, 160), (4, 32, 1, 1057, 64)],
                             ids=["stablelm_12b", "zamba2_1p2b"])
    def test_path_shapes_fill_the_card(self, B, K, R, S, hd):
        p = dec.plan(B, K, R, S, hd, None, h100_resident)
        assert p.cluster * K * p.groups * B >= 132
        assert p.cluster > 1 and p.groups == 1

    def test_device_plan_asks_the_card(self, monkeypatch):
        """On the card the plan's residency comes from the library's
        occupancy query (dtype, hd, heads, cluster), each argument in its
        place."""
        import contextlib

        asked = []

        class Library:
            def repro_flash_decode_clusters(self, dtype, hd, heads, cluster):
                asked.append((dtype, hd, heads, cluster))
                return h100_resident(cluster, heads)

        monkeypatch.setattr(dec._build, "library", Library)
        monkeypatch.setattr(dec.torch.cuda, "device", lambda index: contextlib.nullcontext())
        dec._resident.cache_clear()
        try:
            got = dec._device_plan.__wrapped__(0, 1, 4, 8, 4, 545, 160, None)
        finally:
            dec._resident.cache_clear()
        assert got == dec.plan(4, 8, 4, 545, 160, None, h100_resident)
        assert asked and all(a[:3] == (1, 160, 4) for a in asked)
        assert {a[3] for a in asked} == set(range(got.cluster, 17))

    @pytest.mark.parametrize("S,shards,window", [(2048, 16, None), (2048, 16, 4096),
                                                 (300, 4, 100), (77, 7, None)])
    def test_every_key_of_a_shard_in_one_split(self, S, shards, window):
        """A shard of ``S`` entries (global keys [offset, offset + S)): its
        blocks read each of the row's keys that fall in it once, for every
        global length and offset of the cache's shards."""
        p = dec.plan(8, 8, 4, S, 160, window, h100_resident)
        for offset in range(0, shards * S, S):
            for length in range(1, shards * S + 1, 7):
                first = max(0, length - window) if window else 0
                splits = [dec.split_keys(p, length, window, rank, offset=offset, S=S)
                          for rank in range(p.cluster)]
                want = range(max(0, first - offset), max(0, min(S, length - offset)))
                got = sorted(k for s in splits for k in s)
                assert got == list(want), (offset, length)

    def test_largest_cluster_the_card_holds(self):
        """Clusters of more than six blocks that do not all fit at once
        (as GPC packing can make them) give way to clusters of six."""
        def resident(cluster, heads):
            return 2 * 132 // cluster if cluster <= 6 else 28

        p = dec.plan(4, 8, 4, 545, 160, None, resident)
        assert (p.cluster, p.chunk, p.heads) == (6, 91, 4)
        assert dec.plan(4, 8, 4, 545, 160, None, lambda c, h: 0).cluster == 1


class TestOpsLayout:
    """ops in the model's (B, S, heads, hd) layout == repro.kernels.ops."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("Sq,Sk,hd,kw", [
        (128, 128, 32, dict()),
        (100, 100, 160, dict(window=40, softcap=30.0)),
        (64, 96, 64, dict(causal=False)),
    ])
    def test_flash_attention(self, dtype, Sq, Sk, hd, kw):
        rng = np.random.default_rng(4)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s, dtype) for s in
                                     [(2, Sq, 4, hd), (2, Sk, 2, hd), (2, Sk, 2, hd)])
        got = ops.flash_attention(q, k, v, scale=hd ** -0.5, **kw)
        want = jops.flash_attention(jq, jk, jv, scale=hd ** -0.5, use_pallas=False, **kw)
        assert got.shape == q.shape
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("H,K,hd", [(5, 1, 128), (6, 2, 64), (16, 2, 128), (24, 2, 128),
                                        (8, 8, 64)])
    def test_flash_attention_groupings(self, dtype, H, K, hd):
        """The q_per_kv of the configs (5, 3, 8, 12, 1), which the CUDA kernel
        packs into its 128-row blocks, through the plain version."""
        rng = np.random.default_rng(6)
        (jq, q), (jk, k), (jv, v) = (pair(rng, s, dtype) for s in
                                     [(1, 70, H, hd), (1, 70, K, hd), (1, 70, K, hd)])
        got = ops.flash_attention(q, k, v, scale=hd ** -0.5, window=33)
        want = jops.flash_attention(jq, jk, jv, scale=hd ** -0.5, use_pallas=False, window=33)
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S,hd,kw", [(256, 32, dict()), (545, 160, dict(window=64))])
    def test_decode_attention(self, dtype, S, hd, kw):
        rng = np.random.default_rng(5)
        (jq, q), (jk, kc), (jv, vc) = (pair(rng, s, dtype) for s in
                                       [(2, 1, 4, hd), (2, S, 2, hd), (2, S, 2, hd)])
        pos = np.array([100, S], np.int32)
        got = ops.decode_attention(q, kc, vc, torch.from_numpy(pos), scale=hd ** -0.5, **kw)
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), scale=hd ** -0.5,
                                     use_pallas=False, **kw)
        assert got.shape == q.shape
        assert_close(got, want, dtype)

    def test_cpu_runs_no_kernel(self):
        before, shapes = dict(ops.LAUNCHES), dict(ops.LAUNCH_SHAPES)
        x = torch.randn(1, 8, 2, 16)
        ops.flash_attention(x, x, x, scale=0.25)
        ops.decode_attention(x[:, :1], x, x, torch.tensor([8]), scale=0.25)
        ops.ssd(x, -x[..., 0].abs(), x[:, :, 0], x[:, :, 1], chunk=4)
        assert ops.LAUNCHES == before and dict(ops.LAUNCH_SHAPES) == shapes


def ssd_inputs(rng, B, S, nh, hd, N, dtype):
    """Model-layout SSD inputs as (JAX, torch) pairs: x (B,S,nh,hd), the log
    decays a (B,S,nh) f32 (negative), B and C (B,S,N) scaled by 0.3, as
    tests/kernels/test_kernels.py draws them."""
    x = pair(rng, (B, S, nh, hd), dtype)
    a_np = (-np.abs(rng.standard_normal((B, S, nh))) * 0.1).astype(np.float32)
    a = (jnp.asarray(a_np), torch.from_numpy(a_np))
    return x, a, pair(rng, (B, S, N), dtype, 0.3), pair(rng, (B, S, N), dtype, 0.3)


def tpu_layout(x, a, Bm, Cm, Q):
    """Model layout -> the Pallas kernel's (B, nh, nC, Q, ...) layout, B and
    C copied to every head as JAX's ops.ssd does."""
    B, S, nh, hd = x.shape
    N, nC = Bm.shape[-1], S // Q
    return (x.reshape(B, nC, Q, nh, hd).transpose(0, 3, 1, 2, 4),
            a.reshape(B, nC, Q, nh).transpose(0, 3, 1, 2),
            jnp.broadcast_to(Bm.reshape(B, 1, nC, Q, N), (B, nh, nC, Q, N)),
            jnp.broadcast_to(Cm.reshape(B, 1, nC, Q, N), (B, nh, nC, Q, N)))


class TestSSDIntraChunk:
    # (B, nh, nC, Q, hd, N): tests/kernels/test_kernels.py's, and the chunk of
    # the full mamba2-2.7b config.
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,nh,nC,Q,hd,N", [
        (2, 3, 4, 32, 16, 8), (1, 2, 2, 64, 64, 128), (1, 2, 1, 256, 64, 128)])
    def test_ref_matches_jax(self, dtype, B, nh, nC, Q, hd, N):
        rng = np.random.default_rng(6)
        jx, x = pair(rng, (B, nh, nC, Q, hd), dtype)
        a_np = (-np.abs(rng.standard_normal((B, nh, nC, Q))) * 0.1).astype(np.float32)
        ja, a = jnp.asarray(a_np), torch.from_numpy(a_np)
        (jb, b), (jc, c) = (pair(rng, (B, nh, nC, Q, N), dtype, 0.3) for _ in range(2))
        got = ref.ssd_intra_chunk_ref(x, a, b, c)
        assert all(t.dtype == torch.float32 for t in got)
        for g, w_ref, w_pallas in zip(got, jref.ssd_intra_chunk_ref(jx, ja, jb, jc),
                                      jax_ssd_intra_chunk(jx, ja, jb, jc)):
            assert tuple(g.shape) == w_ref.shape
            assert_close(g, w_ref, dtype)
            assert_close(g, w_pallas, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ops_layout(self, dtype):
        """ops.ssd_intra_chunk in the model's layout, B and C by batch only,
        gives the Pallas kernel's three tensors."""
        rng = np.random.default_rng(7)
        (jx, x), (ja, a), (jb, b), (jc, c) = ssd_inputs(rng, 2, 64, 3, 16, 16, dtype)
        got = ops.ssd_intra_chunk(x, a, b, c, chunk=32)
        for g, w in zip(got, jax_ssd_intra_chunk(*tpu_layout(jx, ja, jb, jc, 32))):
            assert tuple(g.shape) == w.shape
            assert_close(g, w, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
    def test_ops_ssd_matches_ssd_chunked(self, dtype, with_h0):
        """ops.ssd (intra-chunk block + the recurrence glue) == the model's
        ssd_chunked: y in x's type, the final state in f32."""
        rng = np.random.default_rng(8)
        (jx, x), (ja, a), (jb, b), (jc, c) = ssd_inputs(rng, 2, 128, 2, 16, 16, dtype)
        jh0, h0 = pair(rng, (2, 2, 16, 16), "float32") if with_h0 else (None, None)
        y, h = ops.ssd(x, a, b, c, chunk=32, h0=h0)
        wy, wh = jax_ssd_chunked(jx, ja, jb, jc, 32, jh0)
        assert y.dtype == x.dtype and h.dtype == torch.float32
        assert_close(y, wy, dtype)
        assert_close(h, wh, dtype)

    def test_ops_ssd_matches_jax_pallas_ssd(self):
        """... and JAX's own ops.ssd with the Pallas kernel in interpret mode
        (which returns the state in x's type, here f32)."""
        rng = np.random.default_rng(9)
        (jx, x), (ja, a), (jb, b), (jc, c) = ssd_inputs(rng, 2, 128, 2, 16, 8, "float32")
        y, h = ops.ssd(x, a, b, c, chunk=32)
        wy, wh = jops.ssd(jx, ja, jb, jc, chunk=32, use_pallas=True, interpret=True)
        assert_close(y, wy, "float32")
        assert_close(h, wh, "float32")

    def test_ragged_sequence_raises(self):
        x = torch.zeros(1, 40, 2, 16)
        with pytest.raises(ValueError, match="multiple"):
            ops.ssd(x, x[..., 0], x[:, :, 0], x[:, :, 0], chunk=16)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_bf16_split_products_hold_the_kernel_tolerance(self, seed):
        """The bf16 kernel's arithmetic, in plain torch at mamba2-2.7b's chunk
        and widths (Q=256, hd=64, N=128) with two heads: the masked, decayed
        f32 scores and the f32 X * decay each split into a bf16 high part and
        the bf16 rounding of the rest, each product summed in f32.  It stays
        under chip_smoke.SSD_TOL's bf16 rule against the plain version; one
        bf16 rounding of those operands does not."""
        smoke = load_module("chip_smoke", ROOT / "chip_smoke.py")
        tol = smoke.SSD_TOL["bfloat16"]
        rng = np.random.default_rng(seed)
        B, nh, Q, hd, N = 1, 2, 256, 64, 128

        def draw(shape, scale=1.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

        # the model's draws, as chip_smoke.ssd_inputs makes them
        x = draw((B, nh, 1, Q, hd)).bfloat16()
        dt = torch.nn.functional.softplus(draw((B, nh, 1, Q)) - 4.0)
        a = dt * -torch.linspace(1.0, 16.0, nh)[None, :, None, None]
        b, c = (draw((B, 1, 1, Q, N), 0.3).bfloat16().expand(B, nh, 1, Q, N) for _ in "bc")
        want = ref.ssd_intra_chunk_ref(x, a, b, c)[:2]

        x32, b32, c32 = x.float(), b.float(), c.float()
        cum = torch.cumsum(a, -1)
        i = torch.arange(Q)
        p = torch.where(i[:, None] >= i[None, :],
                        (c32 @ b32.transpose(-1, -2)) * torch.exp(cum[..., :, None] -
                                                                 cum[..., None, :]), 0.0)
        xd = x32 * torch.exp(cum[..., -1:] - cum)[..., None]

        def split(v):
            hi = v.bfloat16().float()
            return hi, (v - hi).bfloat16().float()

        (ph, pl), (xh, xl) = split(p), split(xd)
        bt = b32.transpose(-1, -2)
        two_part = (ph @ x32 + pl @ x32, bt @ xh + bt @ xl)
        one_part = (ph @ x32, bt @ xh)

        def excess(got):  # the largest |got - want| over the tolerance of its element
            return max(((g - w).abs() / (tol * (1 + w.abs()))).max().item()
                       for g, w in zip(got, want))

        assert excess(two_part) < 1.0
        assert excess(one_part) > 1.0


def load_module(name, path):
    """Imports a script of the repo by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_126flash_prefill_wgmma_kernelILi160ELb0EEEvNS0_11PrefillArgsENS0_7PackingE' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro12_GLOBAL__N_126flash_prefill_wgmma_kernelILi160ELb0EEEvNS0_11PrefillArgsENS0_7PackingE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5repro12_GLOBAL__N_124flash_prefill_f32_kernelILi64EEEvNS0_11PrefillArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro12_GLOBAL__N_124flash_prefill_f32_kernelILi64EEEvNS0_11PrefillArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 1024 bytes smem, 392 bytes cmem[0]
"""


class TestBuild:
    """The build module's report parsing and per-tree hashing (no nvcc
    needed)."""

    def test_parse_ptxas(self):
        wg, f32 = _build.parse_ptxas(PTXAS_REPORT)
        assert "flash_prefill_wgmma_kernel" in wg["name"]
        assert (wg["registers"], wg["spill_stores"], wg["spill_loads"], wg["smem"]) == \
            (168, 8, 12, 0)
        assert (f32["registers"], f32["spill_stores"], f32["spill_loads"], f32["smem"]) == \
            (64, 0, 0, 1024)

    def test_template_args(self):
        wg, f32 = _build.parse_ptxas(PTXAS_REPORT)
        assert _build.template_args(wg["name"]) == [160, 0]
        assert _build.template_args(f32["name"]) == [64]
        assert _build.template_args("_Z3foov") == []

    def test_ab_tool_arguments(self):
        """tools/prefill_ab.py takes each kernel it times, and refuses an
        order that names a tree it was not given."""
        ab = load_module("prefill_ab", ROOT / "tools" / "prefill_ab.py")
        assert set(ab.CASES) == {"flash_prefill", "flash_decode", "ssd_intra_chunk"}
        args = ab.parse_args(["--kernel", "ssd_intra_chunk", "--tree", "old=build/old",
                              "--tree", "new=src/repro_torch/csrc",
                              "--order", "old,new,new,old"])
        assert args.kernel == "ssd_intra_chunk" and args.order == ["old", "new", "new", "old"]
        assert args.trees == {"old": "build/old", "new": "src/repro_torch/csrc"}
        assert ab.parse_args(["--tree", "a=x", "--order", "a"]).kernel == "flash_prefill"
        with pytest.raises(SystemExit):
            ab.parse_args(["--tree", "a=x", "--order", "a,b"])
        with pytest.raises(SystemExit):
            ab.parse_args(["--kernel", "ssd", "--tree", "a=x", "--order", "a"])
        assert ab.SSD_SHAPES["mamba2_2p7b"] == (4, 1024, 80, 64, 128, 256, "bfloat16")

    def test_source_hash_follows_the_tree(self, tmp_path):
        a, b, c = (tmp_path / n for n in "abc")
        for d, text in ((a, "int x;"), (b, "int x;"), (c, "int y;")):
            d.mkdir()
            (d / "k.cu").write_text(text)
        assert _build.source_hash(a) == _build.source_hash(b) != _build.source_hash(c)
        assert _build.source_hash() not in {_build.source_hash(a), _build.source_hash(c)}

    def test_probe_patches_the_current_kernel(self):
        """tools/prefill_probe.py instruments a copy of the wgmma kernel at
        anchor lines; every anchor must still be in the source."""
        import importlib.util
        from pathlib import Path

        root = Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("prefill_probe",
                                                      root / "tools" / "prefill_probe.py")
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        text = (_build.CSRC / "flash_attention.cu").read_text()
        patched = probe.patched_source(text)
        assert patched.count("pr_record();") == 2 and "g_probe" in patched

    def test_decode_probe_patches_the_current_kernel(self):
        """tools/decode_probe.py instruments a copy of the bf16 decode kernel
        and its cluster merge at anchor lines; every anchor must still be in
        the source, once."""
        import importlib.util
        from pathlib import Path

        root = Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("decode_probe",
                                                      root / "tools" / "decode_probe.py")
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        patched = probe.patched_source((_build.CSRC / "decode_attention.cu").read_text())
        assert patched.count("pr_t[") == 7 and "g_probe" in patched

    def test_ssd_probe_patches_the_current_kernel(self):
        """tools/ssd_probe.py instruments a copy of the bf16 SSD kernel at
        anchor lines; every anchor must still be in the source, once, and
        every phase gets its clock read."""
        probe = load_module("ssd_probe", ROOT / "tools" / "ssd_probe.py")
        patched = probe.patched_source((_build.CSRC / "ssd_scan.cu").read_text())
        for i in range(len(probe.PHASES)):
            assert f"pr_t[{i}] += clock64() - pr_c;" in patched
        assert "g_probe" in patched and "ssd_intra_chunk_f32_kernel" in patched
