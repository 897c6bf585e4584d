"""The port's training substrate against the JAX package's, on the CPU.

* ``optimizer``: the schedule, AdamW on a quadratic, clipping, ``_q8`` /
  ``_dq8`` (bit-equal to JAX's, ties included) and int8-state convergence;
* ``losses.chunked_xent`` against the unchunked loss, with a mask and a
  softcap, and against JAX's;
* ``data.TokenPipeline``: batches bit-equal to the JAX copy's;
* ``compression`` and ``quorum_grad`` against JAX;
* ``checkpoint``: JAX's checkpoints restore in the port and the port's in
  JAX (plain trees with bf16 leaves, f32 and int8 training states), and a
  corrupt shard is detected;
* one train step of each family's smoke config with int8 moments against
  JAX's (the other step tests are in tests/test_torch_train_step.py);
* ``weights.train_state_from_jax`` refuses a state that does not fit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import quorum_grad as jquorum
from repro.train.losses import chunked_xent as jax_chunked_xent
from repro_torch import train as ttrain
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.train import checkpoint, compression, data, optimizer, quorum_grad
from repro_torch.train.losses import chunked_xent
from repro_torch.weights import flatten, load_jax_params, train_state_from_jax
from test_torch_train_step import (FAMILIES, batch_np, bridged, check_metrics, check_state,
                                   to_jax, to_torch)

# f32 on both sides, summed in other orders.
RTOL = 1e-5


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_schedule_matches_jax():
    for ocfg in (optimizer.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
                 optimizer.OptConfig(), optimizer.OptConfig(warmup_steps=0, total_steps=5)):
        jcfg = jopt.OptConfig(**ocfg.__dict__)
        for s in [0, 1, 5, 10, 11, 55, 99, 100, 150, 10_000]:
            got = float(optimizer.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
            want = float(jopt.schedule(jcfg, jnp.asarray(s, jnp.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (ocfg, s)
    ocfg = optimizer.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(optimizer.schedule(ocfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5) and lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4] and lrs[4] == pytest.approx(0.1, abs=0.01)


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_on_a_quadratic_matches_jax(int8):
    """50 steps of AdamW on sum(w^2) (its gradient 2w) beside JAX's: both
    fall below 1.  In f32 the two trajectories agree at f32 precision.
    With int8 moments an int8 level that f32 rounding sets differently
    changes the later steps, so each step starts from JAX's state and the
    update is held within lr / 127, as far as one level (1/127 of the
    block's largest moment) moves it."""
    kw = dict(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.01, int8_state=int8,
              int8_block=64)
    ocfg, jcfg = optimizer.OptConfig(**kw), jopt.OptConfig(**kw)
    w0 = np.linspace(-4, 4, 128, dtype=np.float32).reshape(2, 64)
    params, jparams = {"w": torch.tensor(w0)}, {"w": jnp.asarray(w0)}
    state, jstate = optimizer.init(ocfg, params), jopt.init(jcfg, jparams)
    atol = 0.1 / 127 if int8 else 1e-5
    for _ in range(50):
        if int8:  # from JAX's state
            params = {"w": torch.tensor(np.asarray(jparams["w"]))}
            state = optimizer.AdamState(
                *(jax.tree.map(lambda a: torch.tensor(np.asarray(a)), x)
                  for x in (jstate.m, jstate.v)), torch.tensor(np.asarray(jstate.step)))
        params, state, m = optimizer.update(ocfg, params, {"w": 2 * params["w"]}, state)
        jparams, jstate, jm = jopt.update(jcfg, jparams, {"w": 2 * jparams["w"]}, jstate)
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                                   rtol=1e-5, atol=atol)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    assert float(params["w"].abs().max()) < 1.0 and float(jnp.abs(jparams["w"]).max()) < 1.0
    assert int(state.step) == 50


def test_grad_clipping():
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = optimizer.init(ocfg, params)
    params, _, metrics = optimizer.update(ocfg, params, {"w": torch.full((4,), 100.0)}, state)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # clipped to norm 1: the first Adam step is lr * sign(g) whatever the scale
    np.testing.assert_allclose(params["w"].numpy(), -1e-3, rtol=1e-5)


@pytest.mark.parametrize("shape,block", [((3, 100), 32), ((64,), 64), ((2, 3, 5), 4), ((), 8)])
def test_q8_bit_equal_to_jax(shape, block):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    if x.size > 4:  # exact ties: 127 * k / 2 over a scale of 1 round half to even
        flat = x.reshape(-1)
        flat[:4] = [127.0, 0.5, 1.5, -2.5]
    q, s = optimizer._q8(torch.tensor(x), block)
    jq, js = jopt._q8(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = optimizer._dq8(q, s, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jopt._dq8(jq, js, shape)))
    assert back.shape == shape


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_int8_state(family):
    """One train step with int8 moments against JAX's, as the steps of
    tests/test_torch_train_step.py."""
    cfg, ocfg, state, jstate, jcfg = bridged(FAMILIES[family], int8_state=True, int8_block=16)
    b = batch_np(cfg, 5)
    jstate, jmetrics = jax.jit(jtrain.make_train_step(jcfg, jtrain.OptConfig(**ocfg)))(
        jstate, to_jax(b))
    state, metrics = ttrain.make_train_step(cfg, ttrain.OptConfig(**ocfg))(state, to_torch(b))
    check_metrics(metrics, jmetrics)
    check_state(state, jstate, ocfg)


def test_int8_state_converges():
    ocfg = optimizer.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, int8_state=True,
                               int8_block=64)
    params = {"w": torch.linspace(-4, 4, 128)}
    state = optimizer.init(ocfg, params)
    assert state.m["w"]["q"].dtype == torch.int8
    for _ in range(60):
        params, state, _ = optimizer.update(ocfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1.0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _xent_inputs(arch, seed=0):
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = get_model(cfg).to_empty(device="cpu")
    load_jax_params(model, numpy_tree(jparams))
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    mask = np.zeros((2, 32), np.float32)
    mask[:, :20] = 1.0
    return cfg, jcfg, model, jparams, hidden, targets, mask


@pytest.mark.parametrize("arch", ["stablelm_12b", "gemma2_2b"])  # untied; tied + softcap 30
def test_chunked_xent(arch):
    cfg, jcfg, model, jparams, hidden, targets, mask = _xent_inputs(arch)
    h, t, m = torch.tensor(hidden), torch.tensor(targets), torch.tensor(mask)
    # against the unchunked loss on the model's own logits (softcap included)
    logp = torch.log_softmax(model.logits(h), dim=-1)
    nll = -logp.gather(-1, t[..., None].long())[..., 0]
    for n_chunks in (1, 3, 8):  # 3 does not divide 32: the rule drops to 2
        loss, metrics = chunked_xent(cfg, model, h, t, n_chunks=n_chunks)
        assert float(loss) == pytest.approx(float(nll.mean()), rel=RTOL)
        assert float(metrics["tokens"]) == 64.0
        loss, metrics = chunked_xent(cfg, model, h, t, m, n_chunks=n_chunks)
        assert float(loss) == pytest.approx(float((nll * m).sum() / m.sum()), rel=RTOL)
        assert float(metrics["tokens"]) == 40.0
        # against JAX's
        jloss, jmetrics = jax_chunked_xent(jcfg, jparams, jnp.asarray(hidden),
                                           jnp.asarray(targets), jnp.asarray(mask),
                                           n_chunks=n_chunks)
        assert float(loss) == pytest.approx(float(jloss), rel=RTOL)
        for k in ("accuracy", "tokens"):
            assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=RTOL)


def test_chunked_xent_gradient():
    """The loss's gradients through the checkpointed chunks against JAX's,
    to the hidden states and the unembedding."""
    cfg, jcfg, model, jparams, hidden, targets, mask = _xent_inputs("stablelm_12b", seed=1)
    model.requires_grad_(True)
    h = torch.tensor(hidden, requires_grad=True)
    loss, _ = chunked_xent(cfg, model, h, torch.tensor(targets), torch.tensor(mask))
    loss.backward()

    def jloss(params, hidden):
        return jax_chunked_xent(jcfg, params, hidden, jnp.asarray(targets),
                                jnp.asarray(mask))[0]

    jg_params, jg_hidden = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(hidden))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jg_hidden), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(model.unembed.grad.numpy(), np.asarray(jg_params["unembed"]),
                               rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_token_pipeline_bit_equal_to_jax():
    for kw in (dict(vocab=100, seq_len=16, global_batch=8, seed=3),
               dict(vocab=256, seq_len=32, global_batch=4, seed=0, n_docs=64, doc_len=128)):
        mine, theirs = data.TokenPipeline(data.DataConfig(**kw)), jdata.TokenPipeline(
            jdata.DataConfig(**kw))
        np.testing.assert_array_equal(mine.docs, theirs.docs)
        for step in (0, 7, 1000):
            for num_shards in (1, 2, 4):
                for shard in range(num_shards):
                    a = mine.batch_at(step, shard=shard, num_shards=num_shards)
                    b = theirs.batch_at(step, shard=shard, num_shards=num_shards)
                    for k in ("tokens", "targets"):
                        assert a[k].dtype == b[k].dtype == np.int32
                        np.testing.assert_array_equal(a[k], b[k])


def test_torch_batch_at():
    pipe = data.TokenPipeline(data.DataConfig(vocab=100, seq_len=16, global_batch=8))
    got = pipe.torch_batch_at(2, device="cpu", shard=1, num_shards=2)
    want = pipe.batch_at(2, shard=1, num_shards=2)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pipe.torch_batch_at(2)


# ---------------------------------------------------------------------------
# compression and quorum
# ---------------------------------------------------------------------------
def test_compression_matches_jax():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((3, 333)).astype(np.float32)
    q, s = compression.compress(torch.tensor(g), block=64)
    jq, js = jcomp.compress(jnp.asarray(g), block=64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compression.decompress(q, s, g.shape).numpy(),
                                  np.asarray(jcomp.decompress(jq, js, g.shape)))
    grads = {"a": g, "b": {"c": rng.standard_normal(50).astype(np.float32)}}
    res = {"a": rng.standard_normal((3, 333)).astype(np.float32) * 0.01,
           "b": {"c": np.zeros(50, np.float32)}}
    tgrads = jax.tree.map(torch.tensor, grads)
    comp, new_res = compression.ef_compress_tree(tgrads, jax.tree.map(torch.tensor, res))
    jcomp_, jres = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, grads),
                                          jax.tree.map(jnp.asarray, res))
    np.testing.assert_array_equal(comp["a"][0].numpy(), np.asarray(jcomp_["a"][0]))
    np.testing.assert_allclose(new_res["b"]["c"].numpy(), np.asarray(jres["b"]["c"]), atol=1e-7)
    back = compression.decompress_tree(comp, tgrads)
    np.testing.assert_allclose(back["a"].numpy(),
                               np.asarray(jcomp.decompress_tree(jcomp_, grads)["a"]), atol=1e-7)
    zeros = compression.zero_residuals(tgrads)
    assert zeros["b"]["c"].dtype == torch.float32 and not zeros["a"].any()


def test_error_feedback_converges():
    w = torch.tensor([4.0, -2.0, 1.0, -0.5] * 32)
    res = {"w": torch.zeros_like(w)}
    for _ in range(200):
        comp, res = compression.ef_compress_tree({"w": 2 * w}, res)
        w = w - 0.05 * compression.decompress_tree(comp, {"w": w})["w"]
    assert float(w.abs().max()) < 0.1


def test_quorum_matches_jax():
    g = {"w": np.stack([np.full(3, 1.0), np.full(3, 2.0), np.full(3, 99.0)]).astype(np.float32),
         "b": {"c": np.arange(12, dtype=np.float32).reshape(3, 2, 2)}}
    for mask in ([1.0, 1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]):
        got = quorum_grad.quorum_mean(jax.tree.map(torch.tensor, g),
                                      torch.tensor(mask, dtype=torch.float32))
        want = jquorum.quorum_mean(jax.tree.map(jnp.asarray, g), jnp.asarray(mask))
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-7)
        np.testing.assert_allclose(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]), rtol=1e-7)
    np.testing.assert_allclose(quorum_grad.quorum_mean(
        {"w": torch.tensor(g["w"])}, torch.tensor([1.0, 1.0, 0.0]))["w"].numpy(), 1.5)
    for mask, f in (([1, 1, 1, 0.0], 1), ([1, 1, 0, 0.0], 1), ([1, 0, 0, 0.0], 3)):
        assert bool(quorum_grad.quorum_ok(torch.tensor(mask), f)) == bool(
            jquorum.quorum_ok(jnp.asarray(mask), f))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _plain_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(10).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
                  "d": np.arange(6, dtype=np.int32).reshape(2, 3)}}


def _torch_tree(tree):
    from repro_torch.weights import to_tensor
    return jax.tree.map(to_tensor, tree)


def _torch_to_numpy(tree):
    def one(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return jax.tree.map(one, tree)


def test_checkpoint_plain_tree_both_ways(tmp_path):
    tree = _plain_tree()
    # JAX writes, the port restores
    man = jckpt.save(str(tmp_path / "j"), 5, jax.tree.map(jnp.asarray, tree), n_shards=2,
                     meta={"arch": "t"})
    like = jax.tree.map(torch.zeros_like, _torch_tree(tree))
    out = checkpoint.restore(str(tmp_path / "j"), man, like)
    assert out is like and out["b"]["c"].dtype == torch.bfloat16
    for got, want in zip(jax.tree.leaves(_torch_to_numpy(out)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    # the port writes, JAX restores; same manifest entries
    man2 = checkpoint.save(str(tmp_path / "t"), 5, _torch_tree(tree), n_shards=2,
                           meta={"arch": "t"})
    assert [{k: e[k] for k in e} for e in man2["entries"]] == man["entries"]
    assert man2["meta"] == man["meta"] and man2["n_shards"] == 2
    back = jckpt.restore(str(tmp_path / "t"), man2, jax.tree.map(jnp.zeros_like,
                                                                 jax.tree.map(jnp.asarray, tree)))
    assert back["b"]["c"].dtype == jnp.bfloat16
    for got, want in zip(jax.tree.leaves(numpy_tree(back)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    assert checkpoint.latest_manifest(str(tmp_path / "t"))["step"] == 5
    assert checkpoint.latest_manifest(str(tmp_path / "none")) is None


@pytest.mark.parametrize("int8", [False, True])
def test_checkpoint_train_state_both_ways(tmp_path, int8):
    """A JAX TrainState (after one step, so the moments are nonzero)
    restores into the port's, leaf names as JAX's tree paths; and the
    port's, after a step of its own, restores in JAX."""
    arch = "stablelm_12b"
    kw = dict(lr=1e-2, warmup_steps=1, int8_state=int8, int8_block=16)
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jstate = jtrain.init_state(jcfg, jtrain.OptConfig(**kw), jax.random.PRNGKey(0))
    pipe = data.TokenPipeline(data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    batch = pipe.batch_at(0)
    jstate, _ = jax.jit(jtrain.make_train_step(jcfg, jtrain.OptConfig(**kw)))(
        jstate, jax.tree.map(jnp.asarray, batch))
    man = jckpt.save(str(tmp_path / "j"), 1, jstate)
    names = {e["name"] for e in man["entries"]}
    assert {".params/blocks/attn/wq", ".opt/.step", ".step"} <= names
    assert (".opt/.m/embed/q" in names) == int8 and (".opt/.m/embed" in names) != int8
    like = ttrain.init_state(cfg, ttrain.OptConfig(**kw), torch.Generator().manual_seed(1),
                             device="cpu")
    state = checkpoint.restore(str(tmp_path / "j"), man, like)
    want = train_state_from_jax(numpy_tree(jstate), cfg, device="cpu")
    assert int(state.step) == int(state.opt.step) == 1
    for (n1, a), (n2, b) in zip(checkpoint._flatten(state), checkpoint._flatten(want)):
        assert n1 == n2 and torch.equal(a, b), n1
    # the port steps on and writes; JAX restores it
    state, _ = ttrain.make_train_step(cfg, ttrain.OptConfig(**kw))(
        state, pipe.torch_batch_at(1, device="cpu"))
    man2 = checkpoint.save(str(tmp_path / "t"), 2, state, n_shards=3)
    assert {e["name"] for e in man2["entries"]} == names
    back = jckpt.restore(str(tmp_path / "t"), man2, jstate)
    assert int(back.step) == int(back.opt.step) == 2
    mine = flatten(jax.tree.map(np.asarray, back.params))
    for name, p in state.params.named_parameters():
        np.testing.assert_array_equal(mine[name], p.detach().numpy())
    m = flatten(jax.tree.map(np.asarray, back.opt.m))
    for name, t in state.opt.m.items():
        if int8:
            np.testing.assert_array_equal(m[f"{name}.q"], t["q"].numpy())
            np.testing.assert_array_equal(m[f"{name}.s"], t["s"].numpy())
        else:
            np.testing.assert_array_equal(m[name], t.numpy())


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.arange(4.0)}
    man = checkpoint.save(str(tmp_path), 1, tree)
    path = tmp_path / man["files"]["0"]["path"]
    path.write_bytes(path.read_bytes()[:-7] + b"garbage")
    with pytest.raises(IOError):
        checkpoint.restore(str(tmp_path), man, tree)
    with pytest.raises(IOError):  # JAX detects it in the port's file too
        jckpt.restore(str(tmp_path), man, {"a": jnp.arange(4.0)})


def test_checkpoint_shape_mismatch_raises(tmp_path):
    man = checkpoint.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), man, {"a": torch.zeros(5)})


# ---------------------------------------------------------------------------
# the training-state bridge
# ---------------------------------------------------------------------------
def test_train_state_from_jax_refuses_misfits():
    arch = "stablelm_12b"
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    ocfg = jtrain.OptConfig(int8_state=True, int8_block=16)
    good = numpy_tree(jtrain.init_state(jcfg, ocfg, jax.random.PRNGKey(0)))
    state = train_state_from_jax(good, cfg, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in state.params.parameters())
    assert state.opt.m["embed"]["q"].dtype == torch.int8
    with pytest.raises(ValueError):  # bf16 masters
        train_state_from_jax(good._replace(params=jax.tree.map(
            lambda a: a.astype(ml_dtypes.bfloat16), good.params)), cfg, device="cpu")
    m = dict(good.opt.m)
    del m["unembed"]
    with pytest.raises(KeyError, match="unembed"):
        train_state_from_jax(good._replace(opt=good.opt._replace(m=m)), cfg, device="cpu")
    m = {**good.opt.m, "embed": {"q": good.opt.m["embed"]["q"][:, :-1],
                                 "s": good.opt.m["embed"]["s"][:, :-1]}}
    with pytest.raises(ValueError, match="embed"):
        train_state_from_jax(good._replace(opt=good.opt._replace(m=m)), cfg, device="cpu")
    with pytest.raises(ValueError, match="step"):
        train_state_from_jax(good._replace(step=np.zeros(1, np.int32)), cfg, device="cpu")
    with pytest.raises(ValueError):  # a config of other widths
        train_state_from_jax(good, cfg.replace(d_model=32), device="cpu")
