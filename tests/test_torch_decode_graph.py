"""The Engine's captured decode step (``serve.graph.CapturedDecode``) on the CPU.

On the CPU the step runs uncaptured on its static buffers: the same
function that the card captures.  On weights bridged from a JAX ``init``:

* the Engine emits the JAX Engine's greedy tokens for ``gemma3_4b`` (QK-norm,
  a window); the other families' such tests (tests/test_torch_engine.py,
  test_torch_moe.py, test_torch_encdec.py) run through the same step;
* for one config of each family the step's logits are bit-equal to eager
  ``make_decode_step``'s at every step, teacher-forced;
* calls of ``generate`` on one Engine with other prompts and batch sizes
  give what fresh Engines give: no state of an earlier call survives, and
  each batch layout has its own captured prefill
  (tests/test_torch_prefill_graph.py holds the prefill itself);
* launch accounting, with a stand-in graph: a capture leaves
  ``ops.LAUNCHES`` / ``LAUNCH_SHAPES`` as they were, each replay adds one
  step's counts.

Marked ``cuda`` (skipped without a card): capture-and-replay equals the
eager step bit for bit on a smoke config, and a capture that fails raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.serve import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serve import Engine, make_decode_step, make_prefill_step
from repro_torch.serve.graph import CapturedDecode, CudaGraph
from repro_torch.weights import load_jax_params

# One config of each family: dense, windowed (and softcapped), MoE, SSM,
# hybrid, encoder-decoder.
FAMILIES = ["stablelm_12b", "gemma2_2b", "grok_1_314b", "mamba2_2p7b", "zamba2_1p2b",
            "seamless_m4t_large_v2"]
SSM_ARCHS = ("mamba2_2p7b", "zamba2_1p2b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke sizes: one torch thread each, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def bridged(arch, seed=0):
    """(JAX config, JAX params, the port's model with the same weights), f32;
    made once an arch (no test changes a weight), JAX's init jitted (a
    third of its eager time)."""
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    jparams = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(seed))
    model = get_model(get_smoke_config(arch).replace(dtype="float32")).init(
        torch.Generator().manual_seed(seed), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, model


def batch(cfg, B, S, seed=0):
    """numpy-seeded prompts (B, S); for the encoder-decoder also enc_emb.
    The SSM families take two smoke chunks, so the inter-chunk recurrence runs."""
    rng = np.random.default_rng(seed)
    S = 32 if cfg.family in ("ssm", "hybrid") else S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_emb"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_greedy_tokens_match_jax_engine_gemma3():
    jcfg, jparams, model = bridged("gemma3_4b")
    b = batch(jcfg, 3, 8)
    want = JaxEngine(jcfg, jparams, max_len=48).generate(
        {k: jnp.asarray(v) for k, v in b.items()}, 6)
    eng = Engine(model, max_len=48, device="cpu")
    got = eng.generate(to_torch(b), 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(eng._steps) == 1  # the one layout went through the captured step
    assert len(eng._prefills) == 1  # and through the captured prefill


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_logits_bit_equal_eager(arch):
    """Teacher-forced on the same tokens, the captured step's logits (run
    uncaptured here) equal eager ``make_decode_step``'s bit for bit."""
    _, _, model = bridged(arch)
    b = to_torch(batch(model.cfg, 2, 8))
    steps, max_len = 5, 48
    forced = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, steps)))
    prefill = make_prefill_step(model, max_len)
    eng = Engine(model, max_len=max_len, device="cpu")
    eager = make_decode_step(model)
    (lg, sg), (le, se) = prefill(b), prefill(b)
    for t in range(steps):
        lg, sg = eng._decode(sg, forced[:, t:t + 1])
        le, se = eager(se, forced[:, t:t + 1])
        assert torch.equal(lg, le), (arch, t)
    step = eng.captured_step(sg)
    assert sg is step.state and torch.equal(sg["pos"], se["pos"])


@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_1p2b", "seamless_m4t_large_v2"])
def test_calls_on_one_engine_match_fresh_engines(arch):
    """Prompts of other lengths and batch sizes through one Engine give
    fresh Engines' tokens: a call at a layout seen before copies the new
    prefill's state in whole."""
    _, _, model = bridged(arch)
    cases = [(2, 8, 0), (3, 6, 1), (2, 12, 2), (2, 8, 0)]
    eng = Engine(model, max_len=40, device="cpu")
    for B, S, seed in cases:
        b = to_torch(batch(model.cfg, B, S, seed))
        got = eng.generate(b, 5).tokens
        np.testing.assert_array_equal(
            got, Engine(model, max_len=40, device="cpu").generate(b, 5).tokens)
    assert len(eng._steps) == 2  # batch 2 and batch 3
    # one captured prefill, the last batch layout's (the SSM families'
    # prompts are all 32 long)
    (step,) = eng._prefills.values()
    B, S, _ = cases[-1]
    assert tuple(step.inputs["tokens"].shape) == (B, 32 if arch in SSM_ARCHS else S)


class StandInGraph:
    """A graph on the CPU: ``capture`` runs the step's Python once, as a
    CUDA capture does, and ``replay`` only counts."""

    def __init__(self):
        self.replays = 0

    def warm_up(self, body):
        return body()

    def capture(self, body):
        return body()

    def replay(self):
        self.replays += 1


def counting_step(state, tokens):
    """A stand-in decode step whose Python counts launches as the kernel
    wrappers do: two flash_decode calls at one shape and one at another."""
    ops.LAUNCHES["flash_decode"] += 3
    ops.LAUNCH_SHAPES["flash_decode", ("local",)] += 2
    ops.LAUNCH_SHAPES["flash_decode", ("global",)] += 1
    return tokens.float()[:, None], {**state, "pos": state["pos"] + 1}


def test_capture_leaves_launch_counts_and_each_replay_adds_a_step():
    ops.reset_launches()
    state = {"pos": torch.zeros(2, dtype=torch.int32)}
    step = CapturedDecode(counting_step, state, StandInGraph)
    tok = torch.ones(2, 1, dtype=torch.long)
    step(state, tok)  # the first step runs uncaptured, then the capture
    assert step.captured and step.graph.replays == 0
    assert ops.LAUNCHES["flash_decode"] == 3  # the first step's launches only
    assert dict(step.launches) == {"flash_prefill": 0, "flash_decode": 3, "ssd_intra_chunk": 0}
    for n in (1, 2, 3):
        step(step.state, tok)
        assert step.graph.replays == n
        assert ops.LAUNCHES["flash_decode"] == 3 * (n + 1)
        assert ops.LAUNCH_SHAPES == {("flash_decode", ("local",)): 2 * (n + 1),
                                     ("flash_decode", ("global",)): n + 1}
    ops.reset_launches()


def test_a_state_of_another_layout_is_refused():
    """The state and the tokens are held to the step's layout alike: another
    batch size or another token type is refused."""
    state = {"pos": torch.zeros(2, dtype=torch.int32)}
    step = CapturedDecode(counting_step, state)
    tok = torch.ones(2, 1, dtype=torch.long)
    for other in (({"pos": torch.zeros(3, dtype=torch.int32)}, tok), (state, tok.int())):
        with pytest.raises(ValueError, match="layout"):
            step(*other)


def test_the_graph_can_be_turned_off():
    """``cuda_graph=False`` runs the eager step: no captured step is made."""
    _, _, model = bridged("stablelm_12b")
    b = to_torch(batch(model.cfg, 2, 8))
    eng = Engine(model, max_len=32, device="cpu", cuda_graph=False)
    out = eng.generate(b, 4)
    assert not eng._steps
    np.testing.assert_array_equal(
        out.tokens, Engine(model, max_len=32, device="cpu").generate(b, 4).tokens)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_1p2b"])
def test_capture_and_replay_bit_equal_eager_on_the_card(cuda, arch):
    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    b = {k: v.to(cuda) for k, v in to_torch(batch(cfg, 2, 8)).items()}
    forced = torch.randint(0, cfg.vocab, (2, 6), device=cuda,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    prefill = make_prefill_step(model, 32)
    eng = Engine(model, max_len=32)
    (lg, sg), (le, se) = prefill(b), prefill(b)
    for t in range(6):
        lg, sg = eng._decode(sg, forced[:, t:t + 1])
        le, se = model.decode_step(se, forced[:, t:t + 1])
        assert torch.equal(lg, le), t
    assert eng.captured_step(sg).captured


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda):
    def syncs(state, tokens):  # a host sync, which a capture refuses
        x = tokens.float()
        if x.sum().item() < 0:
            x = -x
        return x[:, None], {**state, "pos": state["pos"] + 1}

    state = {"pos": torch.zeros(2, dtype=torch.int32, device=cuda)}
    step = CapturedDecode(syncs, state, CudaGraph)
    with pytest.raises(RuntimeError):
        step(state, torch.ones(2, 1, dtype=torch.long, device=cuda))
    assert not step.captured
