"""The port's train step against the JAX package's, on the CPU.

For the smoke config of each family (dense, gemma2 with its softcaps and
window, MoE, SSM, hybrid, encoder-decoder), in f32, on the same masters
(drawn by the port's ``init_state`` and bridged to JAX with
``weights.train_state_to_jax``) and the same numpy batches:

* two ``make_train_step`` steps, each with the loss, metrics and bf16
  gradients of its batch, and the step's metrics, updated masters and
  Adam moments;
* one step with ``microbatches=2`` (one with ``int8_state`` is in
  tests/test_torch_train.py, which shares this file's helpers, so that
  each file runs in about a minute);
* ``remat=True`` against ``remat=False`` (the port alone: equal);
* ``make_eval_step`` against the reference's loss function, which is its
  eval step;

and one bf16 step of the dense config (the forward in bf16 on f32
masters).  Tolerances are stated beside each constant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro.configs import get_smoke_config as jax_smoke_config
from repro.train import optimizer as jopt
from repro.train.train_loop import make_loss_fn as jax_loss_fn
from repro_torch import train as ttrain
from repro_torch.configs import get_smoke_config
from repro_torch.train.data import DataConfig, TokenPipeline
from repro_torch.train.optimizer import _dq8
from repro_torch.train.train_loop import make_grad_fn
from repro_torch.weights import flatten, train_state_to_jax
from test_torch_chip_smoke import smoke

FAMILIES = {"dense": "stablelm_12b", "gemma2": "gemma2_2b", "moe": "grok_1_314b",
            "ssm": "mamba2_2p7b", "hybrid": "zamba2_1p2b", "encdec": "seamless_m4t_large_v2"}
B, S = 4, 32  # two SSM chunks of 16; gemma2's window of 8 cuts; two MoE groups of 64
# The tolerances of chip_smoke.py's gate (a), which holds the port on the
# card against the port on the CPU; the reasons are beside them there.
LR, METRIC_RTOL = smoke.PARITY_LR, smoke.PARITY_METRIC_RTOL
PARAM_ATOL, PARAM_SHARE, PARAM_FAR = (smoke.PARITY_PARAM_ATOL, smoke.PARITY_PARAM_SHARE,
                                      smoke.PARITY_PARAM_FAR)
MOMENT_RTOL, MOMENT_ATOL_FRAC = smoke.PARITY_MOMENT_RTOL, smoke.PARITY_MOMENT_ATOL_FRAC
# A bf16 gradient is the f32 one rounded; two f32 values ~1e-6 apart round
# to the same bf16 value or to neighbours, at most one bf16 step (2^-7
# relative) apart; near zero, the f32 difference itself (~1e-6 of the
# tensor's largest element).
GRAD_RTOL, GRAD_ATOL_FRAC = 2.0 ** -7, 1e-6
# bf16: both sides round at the same places, but their matmuls sum in
# other orders, so a rounding may land one bf16 step (2^-8 relative) apart,
# a few of which reach the loss (~5.5) and the grad norm.
BF16_RTOL = 1e-2


def batch_np(cfg, step, batch=B):
    b = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=batch)).batch_at(step)
    if cfg.family == "encdec":
        rng = np.random.default_rng(step)
        b["enc_emb"] = rng.standard_normal((batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def bridged(arch, dtype="float32", seed=0, **opt_kw):
    """(port config, OptConfig kwargs, port state, the same state as a JAX
    TrainState, the JAX config)."""
    ocfg = dict(lr=LR, warmup_steps=1, **opt_kw)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    state = ttrain.init_state(cfg, ttrain.OptConfig(**ocfg), torch.Generator().manual_seed(seed),
                              device="cpu")
    np_state = train_state_to_jax(state)
    jstate = jtrain.TrainState(
        params=to_jax(np_state.params),
        opt=jopt.AdamState(m=to_jax(np_state.opt.m), v=to_jax(np_state.opt.v),
                           step=jnp.asarray(np_state.opt.step)),
        step=jnp.asarray(np_state.step))
    return cfg, ocfg, state, jstate, jax_smoke_config(arch).replace(dtype=dtype)


def check_metrics(got, want, rtol=METRIC_RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)


def check_close(name, got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def check_state(state, jstate, ocfg):
    jparams = flatten(jax.tree.map(np.asarray, jstate.params))
    far = total = 0
    for name, p in state.params.named_parameters():
        d = np.abs(p.detach().numpy() - jparams[name])
        assert d.max() <= PARAM_ATOL, name
        far += int((d > PARAM_FAR).sum())
        total += d.size
    assert far <= PARAM_SHARE * total, (far, total)
    for which in ("m", "v"):
        jm = flatten({k: v for k, v in jax.tree.map(np.asarray, getattr(jstate.opt, which)).items()})
        for name, got in getattr(state.opt, which).items():
            shape = tuple(state.params.get_parameter(name).shape)
            if ocfg.get("int8_state"):
                q, s = torch.tensor(jm[f"{name}.q"]), torch.tensor(jm[f"{name}.s"])
                want, step = _dq8(q, s, shape), s.max().item()
                got = _dq8(got["q"], got["s"], shape)
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MOMENT_RTOL,
                                           atol=1.01 * step, err_msg=f"{which}/{name}")
            else:
                check_close(f"{which}/{name}", got.numpy(), jm[name], MOMENT_RTOL,
                            MOMENT_ATOL_FRAC)
    assert int(state.step) == int(jstate.step) and int(state.opt.step) == int(jstate.opt.step)


def jax_grads_and_step(jcfg, ocfg):
    """One jitted function: the reference's bf16 gradients of a batch (its
    ``grad_fn``) and its train step on it."""
    step = jtrain.make_train_step(jcfg, jtrain.OptConfig(**ocfg))

    def fn(state, batch):
        (loss, metrics), grads = jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True)(
            state.params, batch)
        grads = jax.tree.map(lambda g: g.astype(jnp.bfloat16), grads)
        return ({**metrics, "loss": loss}, grads), step(state, batch)

    return jax.jit(fn)


def check_grads(grads, jgrads):
    jg = flatten(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads))
    assert set(grads) == set(jg)
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16
        check_close(name, g.float().numpy(), jg[name], GRAD_RTOL, GRAD_ATOL_FRAC)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_steps(family):
    """Each of two steps: the loss and metrics of its batch (also through
    ``make_eval_step``) and, on the first (where the masters are equal),
    its bf16 gradients; then the
    step's metrics, masters and moments.  (After a step the masters differ
    by up to the PARAM_FAR of a few elements, which moves the next
    gradients by more than rounding.)"""
    cfg, ocfg, state, jstate, jcfg = bridged(FAMILIES[family])
    grad_fn = make_grad_fn(cfg)
    step = ttrain.make_train_step(cfg, ttrain.OptConfig(**ocfg))
    jfn = jax_grads_and_step(jcfg, ocfg)
    for i in range(2):
        b = batch_np(cfg, i)
        (jloss_metrics, jgrads), (jstate, jmetrics) = jfn(jstate, to_jax(b))
        loss, metrics, grads = grad_fn(state.params, to_torch(b))
        check_metrics({**metrics, "loss": loss}, jloss_metrics)
        # JAX's eval step is its loss function, whose metrics these are
        check_metrics(ttrain.make_eval_step(cfg)(state.params, to_torch(b)), jloss_metrics)
        if i == 0:
            check_grads(grads, jgrads)
        state, metrics = step(state, to_torch(b))
        check_metrics(metrics, jmetrics)
        check_state(state, jstate, ocfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_microbatches(family):
    cfg, ocfg, state, jstate, jcfg = bridged(FAMILIES[family])
    b = batch_np(cfg, 3)
    jstate, jmetrics = jax.jit(jtrain.make_train_step(
        jcfg, jtrain.OptConfig(**ocfg), microbatches=2))(jstate, to_jax(b))
    state, metrics = ttrain.make_train_step(cfg, ttrain.OptConfig(**ocfg), microbatches=2)(
        state, to_torch(b))
    check_metrics(metrics, jmetrics)
    check_state(state, jstate, ocfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_changes_nothing(family):
    """Per-layer recomputation gives the same loss and gradients, bit for
    bit: the backward recomputes each layer's forward with the same ops."""
    cfg, _, state, _, _ = bridged(FAMILIES[family])
    model, b = state.params, to_torch(batch_np(cfg, 1))
    inputs = b if cfg.family == "encdec" else b["tokens"]
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        hidden, aux = model.hidden_states(inputs, with_aux=True, remat=remat)
        loss, _ = ttrain.losses.chunked_xent(cfg, model, hidden, b["targets"])
        if aux:
            loss = loss + 0.01 * aux["moe_lb_loss"]
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][1]:
        assert torch.equal(out[0][1][name], out[1][1][name]), name


def test_bf16_step_on_f32_masters():
    """The dense config in bf16: the forward casts the embedding rows and
    each layer's f32 masters to bf16 (the final norm too), as JAX does."""
    cfg, ocfg, state, jstate, jcfg = bridged("stablelm_12b", dtype="bfloat16")
    b = batch_np(cfg, 0)
    hidden = state.params.hidden_states(to_torch(b)["tokens"])
    assert hidden.dtype == torch.bfloat16
    jstate, jmetrics = jax.jit(jtrain.make_train_step(jcfg, jtrain.OptConfig(**ocfg)))(
        jstate, to_jax(b))
    state, metrics = ttrain.make_train_step(cfg, ttrain.OptConfig(**ocfg))(state, to_torch(b))
    check_metrics(metrics, jmetrics, rtol=BF16_RTOL)
