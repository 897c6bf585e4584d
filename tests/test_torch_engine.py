"""The port's serving engine against the JAX Engine, on the CPU.

Greedy generation on weights bridged from a JAX ``init`` emits the JAX
Engine's tokens, for the dense and the SSM/hybrid smoke configs (the SSM
ones on prompts of two smoke chunks, so the inter-chunk recurrence runs).  Also, as tests/serve/test_engine.py checks the JAX
engine: prefill lands in the state that stepwise decode reaches, EOS stops
generation, greedy is deterministic; and temperature sampling (which cannot
match ``jax.random`` token for token) gives tokens of the right shape and
range, the same for the same generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.serve import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serve import Engine, make_decode_step, make_prefill_step
from repro_torch.weights import load_jax_params


def setup(arch, B=2, S=8, seed=0):
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    model = get_model(get_smoke_config(arch).replace(dtype="float32")).init(
        torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, jparams, model, tokens


SSM_ARCHS = ["mamba2_2p7b", "zamba2_1p2b"]


def prompt_len(arch, dense_len):
    """Two chunks of the smoke SSM chunk (16) for the SSM families."""
    return 32 if arch in SSM_ARCHS else dense_len


@pytest.mark.parametrize("arch", ["stablelm_12b", "gemma2_2b", *SSM_ARCHS])
def test_greedy_tokens_match_jax_engine(arch):
    jcfg, jparams, model, tokens = setup(arch, B=3, S=prompt_len(arch, 8))
    want = JaxEngine(jcfg, jparams, max_len=48).generate({"tokens": jnp.asarray(tokens)}, 6)
    got = Engine(model, max_len=48, device="cpu").generate(
        {"tokens": torch.from_numpy(tokens)}, 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", ["stablelm_12b", "gemma2_2b", *SSM_ARCHS])
def test_prefill_matches_stepwise_decode(arch):
    _, _, model, tokens = setup(arch, S=prompt_len(arch, 16))
    B, S = tokens.shape
    tok = torch.from_numpy(tokens)
    logits_p, state_p = make_prefill_step(model, max_len=S + 4)({"tokens": tok})
    decode = make_decode_step(model)
    state = model.decode_init(B, S + 4)
    for t in range(S):
        logits_s, state = decode(state, tok[:, t : t + 1])
    np.testing.assert_allclose(logits_p[:, 0].numpy(), logits_s[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)
    nxt = torch.argmax(logits_p[:, -1], dim=-1)[:, None]
    a, _ = decode(state_p, nxt)
    b, _ = decode(state, nxt)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3)


def test_eos_early_stop_and_determinism():
    _, _, model, tokens = setup("stablelm_12b", B=1)
    batch = {"tokens": torch.from_numpy(tokens)}
    eng = Engine(model, max_len=64, device="cpu")
    first = eng.generate(batch, n_steps=5)
    np.testing.assert_array_equal(first.tokens, eng.generate(batch, n_steps=5).tokens)
    eng.eos_id = int(first.tokens[0, 0])
    out = eng.generate(batch, n_steps=10)
    assert out.steps == 1 and out.tokens.shape == (1, 1)


def test_temperature_sampling():
    _, _, model, tokens = setup("stablelm_12b", B=3)
    eng = Engine(model, max_len=32, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    a = eng.generate(batch, 7, temperature=0.8, generator=torch.Generator().manual_seed(5))
    b = eng.generate(batch, 7, temperature=0.8, generator=torch.Generator().manual_seed(5))
    assert a.tokens.shape == (3, 7) and a.steps == 7
    assert (a.tokens >= 0).all() and (a.tokens < model.cfg.vocab).all()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    with pytest.raises(ValueError):
        eng.generate(batch, 2, temperature=0.8)


def test_launcher_on_cpu(capsys):
    serve.main(["--arch", "stablelm_12b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated=3 tokens/request" in out and "(CPU," in out


def test_serve_batch_example_on_cpu(capsys):
    """examples/serve_batch_torch.py serves its five families on the CPU."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_batch_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batch_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all engines deterministic under greedy decoding" in out
    for family in ("dense", "ssm", "hybrid", "encdec", "moe"):
        assert f"({family:6s})" in out
