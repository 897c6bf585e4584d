"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it runs on a machine with torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as tests/kernels/test_kernels.py: f32 2e-4, bf16 3e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
pytestmark = pytest.mark.cuda


def assert_close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("Sq,Sk,hd,kw", [
        (512, 512, 160, dict()),
        (333, 333, 160, dict()),
        (300, 300, 256, dict(window=128, softcap=50.0)),
        (100, 333, 64, dict(causal=False)),
        (200, 200, 16, dict()),
        (200, 200, 128, dict()),
    ])
    def test_flash_prefill(self, cuda, dtype, Sq, Sk, hd, kw):
        td = DTYPES[dtype]
        g = torch.Generator(device=cuda).manual_seed(0)
        q, k, v = (torch.randn(s, generator=g, device=cuda).to(td)
                   for s in [(2, Sq, 8, hd), (2, Sk, 2, hd), (2, Sk, 2, hd)])
        n = ops.LAUNCHES["flash_prefill"]
        got = ops.flash_attention(q, k, v, scale=hd ** -0.5, **kw)
        assert ops.LAUNCHES["flash_prefill"] == n + 1
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       scale=hd ** -0.5, **kw).transpose(1, 2)
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("S,hd,lengths,kw", [
        (545, 160, [545, 513, 529, 1], dict()),
        (400, 256, [400, 150, 77, 2], dict(window=128, softcap=50.0)),
        (300, 64, [300, 123, 5, 299], dict()),
        (100, 64, [100, 64, 1, 65], dict(batch=64)),  # enough blocks: no split
    ])
    def test_flash_decode(self, cuda, dtype, S, hd, lengths, kw):
        td = DTYPES[dtype]
        g = torch.Generator(device=cuda).manual_seed(1)
        B = kw.pop("batch", 4)
        q, kc, vc = (torch.randn(s, generator=g, device=cuda).to(td)
                     for s in [(B, 1, 8, hd), (B, S, 2, hd), (B, S, 2, hd)])
        lens = torch.tensor((lengths * B)[:B], dtype=torch.int32, device=cuda)
        n = ops.LAUNCHES["flash_decode"]
        got = ops.decode_attention(q, kc, vc, lens, scale=hd ** -0.5, **kw)
        assert ops.LAUNCHES["flash_decode"] == n + 1
        want = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                        scale=hd ** -0.5, **kw)[:, None]
        assert_close(got, want, dtype)


def test_unaligned_rows_raise(cuda):
    x = torch.randn(1, 8, 2, 161, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(x, x, x, scale=0.1)
    with pytest.raises(ValueError, match="aligned"):
        ops.decode_attention(x[:, :1], x, x, torch.tensor([8], device=cuda), scale=0.1)
