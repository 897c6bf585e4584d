"""The plain references: against themselves (their own blocking and chunking
change nothing, causality), against a step-by-step recurrence, and against
the port's model in f32 at tiny sizes; and they import nothing of the port."""

import ast
from pathlib import Path

import pytest
import torch

from perfbench import outputs, program, seeded
from perfbench.reference import dense, ssm
from perfbench.reference.common import exact_f32, mm
from perfbench.spec import Bench
from perfbench.testkit import SMALL


def _sequential_ssd(x, a, B, C):
    R, T, nh, hd = x.shape
    h = torch.zeros(R, nh, hd, B.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(T):
        h = h * torch.exp(a[:, t].double())[..., None, None] \
            + x[:, t].double()[..., None] * B[:, t].double()[:, None, None, :]
        ys.append(torch.einsum("rhpn,rn->rhp", h, C[:, t].double()))
    return torch.stack(ys, dim=1)


def test_ssd_matches_its_recurrence_at_any_chunk():
    g = torch.Generator().manual_seed(0)
    R, T, nh, hd, N = 2, 37, 3, 4, 5
    x = torch.randn(R, T, nh, hd, generator=g)
    a = -torch.rand(R, T, nh, generator=g) * 2
    B, C = torch.randn(R, T, N, generator=g), torch.randn(R, T, N, generator=g)
    want = _sequential_ssd(x, a, B, C)
    for chunk in (1, 4, 16, 64):
        got = ssm.ssd(x, a, B, C, chunk=chunk)
        torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)


def _weights(name, seed=3):
    cfg = Bench().cell("stablelm_12b.decode" if name == "dense" else "mamba2_2p7b.decode").config
    cfg = {**cfg, "model": {**cfg["model"], **SMALL[name], "dtype": "float32",
                            "attn_impl": "naive"}}
    model = program.build_model(cfg, seed, "cpu")
    W = outputs.SeededWeights(cfg["init"], *program.leaf_layouts(model), seed, "cpu")
    return cfg, model, W


def test_dense_attention_blocks_and_causality(monkeypatch):
    cfg, _, W = _weights("dense")
    m = program.reference_sizes(cfg)
    tokens = torch.randint(0, m["vocab"], (2, 40), generator=torch.Generator().manual_seed(1))
    with exact_f32():
        whole = dense.logits(m, W, tokens, 0)
        monkeypatch.setattr(dense, "Q_BLOCK", 7)
        torch.testing.assert_close(dense.logits(m, W, tokens, 0), whole, rtol=1e-5, atol=1e-5)
        later = tokens.clone()
        later[:, 30:] = (later[:, 30:] + 1) % m["vocab"]
        torch.testing.assert_close(dense.logits(m, W, later, 0)[:, :30], whole[:, :30])


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_reference_matches_the_port_in_f32(family):
    cfg, model, W = _weights(family)
    ref = dense if family == "dense" else ssm
    m = program.reference_sizes(cfg)
    tokens = torch.randint(0, m["vocab"], (2, 48), generator=torch.Generator().manual_seed(2))
    with exact_f32(), torch.no_grad():
        want = model.apply(tokens)
        got = ref.logits(m, W, tokens, 5)
    torch.testing.assert_close(got, want[:, 5:], rtol=2e-4, atol=2e-4)


def test_the_seeded_draws_are_the_references_and_differ_by_seed():
    cfg, model, W = _weights("dense")
    p = dict(model.named_parameters())
    torch.testing.assert_close(W("blocks.mlp.w_in", 1), p["blocks.mlp.w_in"][1].float())
    torch.testing.assert_close(W("embed", None), p["embed"].float())
    _, other, _ = _weights("dense", seed=4)
    assert not torch.equal(dict(other.named_parameters())["embed"], p["embed"])
    assert seeded.sub_seed(2**33 + 5, "x") != seeded.sub_seed(5, "x")


def test_fp8_control_rounds_both_operands():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 64, generator=g), torch.randn(64, 8, generator=g)
    exact, low = mm(x, w), mm(x, w, "fp8")
    err = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < err < 0.1


def test_references_import_nothing_of_the_port():
    root = Path(__file__).parent
    for path in list((root / "reference").glob("*.py")) + [root / "outputs.py", root / "seeded.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, name)
