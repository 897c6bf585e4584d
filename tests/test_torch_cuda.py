"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it runs on a machine with torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as tests/kernels/test_kernels.py: f32 2e-4, bf16 3e-2; but the
SSD kernel's f32 outputs from bf16 inputs are held at 1e-3, since its
products are exact and only the order of its f32 sums differs from the
plain version (1.2e-4 max abs at mamba2-2.7b's shape on an H100).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.mamba2 import ssd_chunked

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 1e-3}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
pytestmark = pytest.mark.cuda


def assert_close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol[dtype], atol=tol[dtype])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("Sq,Sk,H,K,hd,kw", [
        (512, 512, 8, 2, 160, dict()),
        (333, 333, 8, 2, 160, dict()),
        (300, 300, 8, 2, 256, dict(window=128, softcap=50.0)),
        (100, 333, 8, 2, 64, dict(causal=False)),
        (200, 200, 8, 2, 16, dict()),
        (200, 200, 8, 2, 128, dict()),
        (200, 200, 8, 2, 32, dict()),
        # each q_per_kv of the configs: 1, 2, 5, 6, 8 and 12 query heads
        # per KV head packed into one block's 128 rows (125 and 120 used)
        (200, 200, 8, 8, 64, dict()),
        (200, 200, 8, 4, 128, dict()),
        (150, 150, 10, 2, 128, dict()),
        (150, 150, 12, 2, 64, dict()),
        (150, 150, 16, 2, 128, dict()),
        (150, 150, 24, 2, 128, dict()),
        (40, 40, 130, 1, 64, dict()),  # more heads than rows: two blocks per group
        # short and ragged prompts
        (1, 1, 8, 2, 160, dict()),
        (17, 17, 8, 2, 160, dict()),
        (64, 64, 8, 2, 64, dict()),  # one q tile, one key tile
        (64, 64, 8, 8, 128, dict()),
        # a window whose edge crosses packed tiles, with and without softcap
        (300, 300, 8, 2, 128, dict(window=40)),
        (300, 300, 12, 2, 64, dict(window=40, softcap=30.0)),
        (333, 100, 8, 2, 64, dict(causal=False)),  # Sq > Sk
        # q, k and v as (B, heads, S, hd) tensors seen through transposes:
        # heads outside positions, so the threads move Q and the K/V maps
        # order their dimensions the other way
        (200, 200, 8, 2, 160, dict(heads_outer=True)),
        (150, 150, 12, 2, 64, dict(heads_outer=True, window=40)),
    ])
    def test_flash_prefill(self, cuda, dtype, Sq, Sk, H, K, hd, kw):
        td = DTYPES[dtype]
        g = torch.Generator(device=cuda).manual_seed(0)
        kw = dict(kw)
        if kw.pop("heads_outer", False):
            q, k, v = (torch.randn(s, generator=g, device=cuda).to(td).transpose(1, 2)
                       for s in [(2, H, Sq, hd), (2, K, Sk, hd), (2, K, Sk, hd)])
        else:
            q, k, v = (torch.randn(s, generator=g, device=cuda).to(td)
                       for s in [(2, Sq, H, hd), (2, Sk, K, hd), (2, Sk, K, hd)])
        n = ops.LAUNCHES["flash_prefill"]
        key = ("flash_prefill", (2, Sq, Sk, H, K, hd, kw.get("causal", True), kw.get("window"),
                                 kw.get("softcap")))
        m = ops.LAUNCH_SHAPES[key]
        got = ops.flash_attention(q, k, v, scale=hd ** -0.5, **kw)
        assert ops.LAUNCHES["flash_prefill"] == n + 1 and ops.LAUNCH_SHAPES[key] == m + 1
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       scale=hd ** -0.5, **kw).transpose(1, 2)
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S,hd,lengths,kw", [
        (545, 160, [545, 513, 529, 1], dict()),
        (400, 256, [400, 150, 77, 2], dict(window=128, softcap=50.0)),
        (300, 64, [300, 123, 5, 299], dict()),
        (100, 64, [100, 64, 1, 65], dict(batch=64)),  # enough blocks: no split
        # zamba2-1.2b's shape: MHA (q_per_kv 1), hd 64, cache 1057
        (1057, 64, [1057, 1025, 1040, 1032], dict(H=32, K=32)),
        # q_per_kv 5 (one block serves all five), a row of length 1 beside
        # full ones
        (300, 128, [300, 1, 299, 150], dict(H=10, K=2)),
        # q_per_kv 12: two groups of six heads, clusters of 16
        (1057, 64, [1057, 1, 600, 1000], dict(H=12, K=1)),
        # a window of 100 keys cut into four splits of 25: its edge and the
        # split borders fall inside the rows' ranges
        (545, 160, [545, 300, 77, 130], dict(window=100)),
        # one pair per row: the largest cluster the plan makes (16)
        (2048, 64, [2048, 1], dict(batch=2, H=4, K=1)),
        # caches as (B, K, S, hd) tensors seen through a transpose
        (545, 160, [545, 513, 529, 1], dict(heads_outer=True)),
    ])
    def test_flash_decode(self, cuda, dtype, S, hd, lengths, kw):
        td = DTYPES[dtype]
        g = torch.Generator(device=cuda).manual_seed(1)
        kw = dict(kw)
        B, H, K = kw.pop("batch", 4), kw.pop("H", 8), kw.pop("K", 2)
        q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(td)
        if kw.pop("heads_outer", False):
            kc, vc = (torch.randn(B, K, S, hd, generator=g, device=cuda).to(td).transpose(1, 2)
                      for _ in range(2))
        else:
            kc, vc = (torch.randn(B, S, K, hd, generator=g, device=cuda).to(td)
                      for _ in range(2))
        lens = torch.tensor((lengths * B)[:B], dtype=torch.int32, device=cuda)
        n = ops.LAUNCHES["flash_decode"]
        key = ("flash_decode", (B, S, H, K, hd, kw.get("window"), kw.get("softcap")))
        m = ops.LAUNCH_SHAPES[key]
        got = ops.decode_attention(q, kc, vc, lens, scale=hd ** -0.5, **kw)
        assert ops.LAUNCHES["flash_decode"] == n + 1 and ops.LAUNCH_SHAPES[key] == m + 1
        want = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                        scale=hd ** -0.5, **kw)[:, None]
        assert_close(got, want, dtype)


def ssd_inputs(cuda, B, S, nh, hd, N, td, seed=2, a_scale=0.2):
    """x (B,S,nh,hd); a (B,S,nh) f32, negative, up to a_scale deep; B and C
    as the strided column slices of an xBC-like (B, S, nh*hd + 2N) tensor,
    as the model hands them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g, device=cuda).to(td)
    a = -torch.rand(B, S, nh, generator=g, device=cuda) * a_scale
    xbc = (torch.randn(B, S, nh * hd + 2 * N, generator=g, device=cuda) * 0.3).to(td)
    return x, a, xbc[..., nh * hd : nh * hd + N], xbc[..., nh * hd + N :]


class TestDecodeShardsOnCard:
    """``flash_decode`` on sequence shards of a cache (``key_offset``,
    ``return_lse``): each shard's output and log-sum-exp against the plain
    version's on the same shard (an empty shard: output 0, log-sum-exp
    -inf), and the shards merged by ``ops.merge_decode_partials`` against
    the whole-cache kernel and the plain version, one launch a call."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shards,S,H,K,hd,lengths,kw", [
        (1, 545, 8, 2, 160, [545, 300, 77, 1], dict()),
        (2, 512, 8, 2, 128, [256, 257, 255, 1], dict()),
        (5, 500, 8, 2, 64, [500, 100, 101, 7], dict(window=150)),
        # decode_32k's local shape at 16 x 16, cut in length
        (16, 2048, 32, 8, 160, [2048, 1000, 129, 1, 2047, 1500, 64, 900], dict()),
        # gemma2's window and softcap at hd 256: windows across shard edges
        (8, 1024, 8, 4, 256, [1024, 700, 129, 128], dict(window=300, softcap=50.0)),
    ])
    def test_shards_merge_to_the_whole(self, cuda, dtype, shards, S, H, K, hd, lengths, kw):
        td = DTYPES[dtype]
        g = torch.Generator(device=cuda).manual_seed(3)
        B = len(lengths)
        q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(td)
        kc, vc = (torch.randn(B, S, K, hd, generator=g, device=cuda).to(td) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        kw = dict(kw, scale=hd ** -0.5)
        whole = ops.decode_attention(q, kc, vc, lens, **kw)
        n = ops.LAUNCHES["flash_decode"]
        outs, lses = [], []
        cut = S // shards
        for i in range(shards):
            lo = i * cut
            offset = lo if i % 2 else torch.full((B,), lo, dtype=torch.int32, device=cuda)
            o, lse = ops.decode_attention(q, kc[:, lo:lo + cut], vc[:, lo:lo + cut], lens,
                                          key_offset=offset, return_lse=True, **kw)
            po, plse = ref.decode_attention_ref(
                q[:, 0], kc[:, lo:lo + cut].transpose(1, 2), vc[:, lo:lo + cut].transpose(1, 2),
                lens, key_offset=lo, return_lse=True, **kw)
            assert_close(o[:, 0], po, dtype)
            empty = torch.isneginf(plse)
            assert torch.equal(torch.isneginf(lse), empty)
            assert (o[:, 0][empty] == 0).all()
            np.testing.assert_allclose(lse[~empty].cpu().numpy(), plse[~empty].cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
            outs.append(o)
            lses.append(lse)
        assert ops.LAUNCHES["flash_decode"] == n + shards
        merged = ops.merge_decode_partials(outs, lses)
        assert_close(merged, whole, dtype)
        plain = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                         **kw)[:, None]
        assert_close(merged, plain, dtype)


class TestSSDOnCard:
    """The SSD intra-chunk kernel against its plain version, and ops.ssd
    against the model's plain ssd_chunked, on the card."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,S,nh,hd,N,Q", [
        (1, 1024, 4, 64, 128, 256),  # mamba2-2.7b's chunk and widths, fewer heads
        (2, 512, 4, 64, 64, 256),  # zamba2-1.2b's state
        (2, 64, 3, 16, 16, 16),  # the smoke configs
        (1, 96, 2, 16, 128, 32),
        (1, 128, 2, 64, 16, 64),
        (2, 100, 3, 64, 128, 100),  # a prompt shorter than the model's chunk
        (2, 200, 3, 64, 64, 100),
        (2, 3, 3, 64, 128, 1),
        # chunks that end inside a 16-row tile of the tensor-core fragments
        (2, 200, 3, 16, 16, 100),  # the smoke configs' widths
        (1, 70, 2, 16, 64, 35),
        (2, 2, 3, 16, 16, 1),
        (1, 120, 2, 64, 16, 120),
    ])
    def test_intra_chunk(self, cuda, dtype, B, S, nh, hd, N, Q):
        self.check_intra_chunk(cuda, dtype, B, S, nh, hd, N, Q)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("B,S,nh,hd,N,Q", [
        (1, 512, 4, 64, 128, 256), (2, 256, 4, 64, 64, 256), (2, 64, 3, 16, 16, 16)])
    def test_intra_chunk_steep_decay(self, cuda, dtype, B, S, nh, hd, N, Q):
        """Log decays down to -4 a step (-2 on average): across a 64-key
        strip exp(cum[i] - cum[j]) falls to ~e^-128 and underflows to 0 in
        f32, as does the decay to the chunk's end of its early keys."""
        self.check_intra_chunk(cuda, dtype, B, S, nh, hd, N, Q, a_scale=4.0)

    @staticmethod
    def check_intra_chunk(cuda, dtype, B, S, nh, hd, N, Q, a_scale=0.2):
        x, a, b, c = ssd_inputs(cuda, B, S, nh, hd, N, DTYPES[dtype], a_scale=a_scale)
        n = ops.LAUNCHES["ssd_intra_chunk"]
        got = ops.ssd_intra_chunk(x, a, b, c, chunk=Q)
        assert ops.LAUNCHES["ssd_intra_chunk"] == n + 1
        nC = S // Q
        want = ref.ssd_intra_chunk_ref(
            x.reshape(B, nC, Q, nh, hd).permute(0, 3, 1, 2, 4),
            a.reshape(B, nC, Q, nh).permute(0, 3, 1, 2),
            b.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N),
            c.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N))
        for g_, w in zip(got, want):
            assert g_.shape == w.shape and g_.dtype == torch.float32
            assert_close(g_, w, dtype, SSD_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S", [512, 100, 1])  # whole chunks; shorter than one
    def test_ops_ssd_with_h0(self, cuda, dtype, S):
        x, a, b, c = ssd_inputs(cuda, 2, S, 8, 64, 64, DTYPES[dtype], seed=3)
        g = torch.Generator(device=cuda).manual_seed(4)
        h0 = torch.randn(2, 8, 64, 64, generator=g, device=cuda) * 0.5
        y, h = ops.ssd(x, a, b, c, 128, h0)
        wy, wh = ssd_chunked(x, a, b, c, 128, h0)
        assert y.dtype == x.dtype and h.dtype == torch.float32
        assert_close(y, wy, dtype)
        assert_close(h, wh, dtype, SSD_TOL)

    def test_unsupported_sizes_raise(self, cuda):
        x, a, b, c = ssd_inputs(cuda, 1, 64, 2, 32, 16, torch.float32)
        with pytest.raises(ValueError, match="head_dim 32"):
            ops.ssd_intra_chunk(x, a, b, c, chunk=16)
        x, a, b, c = ssd_inputs(cuda, 1, 512, 2, 64, 16, torch.float32)
        with pytest.raises(ValueError, match="chunks of 1 to 256"):
            ops.ssd_intra_chunk(x, a, b, c, chunk=512)


def test_unaligned_rows_raise(cuda):
    x = torch.randn(1, 8, 2, 161, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(x, x, x, scale=0.1)
    with pytest.raises(ValueError, match="aligned"):
        ops.decode_attention(x[:, :1], x, x, torch.tensor([8], device=cuda), scale=0.1)
    xbc = torch.randn(1, 64, 2 * 64 + 2 * 16 + 1, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_intra_chunk(xbc[..., :128].unflatten(-1, (2, 64)), torch.zeros(1, 64, 2,
                            device=cuda), xbc[..., 128:144], xbc[..., 144:], chunk=16)


class TestTrainingOnCard:
    """The kernels have no backward: under autograd each op raises, the
    models' "auto" takes the plain path and "pallas" raises; and one f32
    train step of the smoke config on the card against the same step on
    the CPU."""

    @pytest.mark.parametrize("op", ["flash_attention", "decode_attention", "ssd_intra_chunk",
                                    "ssd"])
    def test_ops_refuse_autograd(self, cuda, op):
        g = torch.Generator(device=cuda).manual_seed(0)
        if op in ("flash_attention", "decode_attention"):
            q = torch.randn(1, 8 if op == "flash_attention" else 1, 4, 64, generator=g,
                            device=cuda, requires_grad=True)
            k, v = (torch.randn(1, 8, 2, 64, generator=g, device=cuda) for _ in range(2))
            if op == "flash_attention":
                call = lambda: ops.flash_attention(q, k, v, scale=0.125)  # noqa: E731
            else:
                lens = torch.tensor([8], dtype=torch.int32, device=cuda)
                call = lambda: ops.decode_attention(q, k, v, lens, scale=0.125)  # noqa: E731
        else:
            x, a, b, c = ssd_inputs(cuda, 1, 64, 2, 64, 16, torch.float32)
            x.requires_grad_(True)
            if op == "ssd":
                call = lambda: ops.ssd(x, a, b, c, 32)  # noqa: E731
            else:
                call = lambda: ops.ssd_intra_chunk(x, a, b, c, chunk=32)  # noqa: E731
        n = dict(ops.LAUNCHES)
        with pytest.raises(RuntimeError, match="no backward.*plain path"):
            call()
        assert dict(ops.LAUNCHES) == n
        with torch.no_grad():
            call()  # the same call without autograd launches the kernel
        assert sum(ops.LAUNCHES.values()) == sum(n.values()) + 1

    @pytest.mark.parametrize("arch", ["stablelm_12b", "mamba2_2p7b", "seamless_m4t_large_v2"])
    def test_auto_under_autograd_is_plain(self, cuda, arch):
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import get_model
        from repro_torch.train import OptConfig, init_state, make_train_step
        from repro_torch.train.data import DataConfig, TokenPipeline

        cfg = get_smoke_config(arch).replace(dtype="float32")
        ocfg = OptConfig(warmup_steps=1)
        state = init_state(cfg, ocfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
                              ).torch_batch_at(0, device=cuda)
        if cfg.family == "encdec":
            batch["enc_emb"] = torch.randn(2, cfg.enc_len, cfg.d_model, device=cuda)
        n = dict(ops.LAUNCHES)
        state, metrics = make_train_step(cfg, ocfg)(state, batch)
        assert dict(ops.LAUNCHES) == n and torch.isfinite(metrics["loss"])
        pallas = get_model(cfg.replace(attn_impl="pallas"))
        pallas.load_state_dict(state.params.state_dict(), assign=True)
        pallas.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            make_train_step(pallas.cfg, ocfg)(state._replace(params=pallas), batch)

    def test_f32_train_step_against_cpu(self, cuda):
        """Two steps of the dense smoke config from the same masters and
        batches, held by chip_smoke.py's gate (a): the loss, grad norm and
        metrics within 5e-5 relative, the masters within 2 lr with at most
        one in a thousand beyond lr / 16, the moments within a bf16 step
        (the reasons are beside its constants)."""
        from test_torch_chip_smoke import smoke

        row = smoke.parity_case("stablelm_12b", {}, cuda)  # raises unless gate (a) holds
        assert row["steps"] == 2 and row["param_abs"] <= smoke.PARITY_PARAM_ATOL
