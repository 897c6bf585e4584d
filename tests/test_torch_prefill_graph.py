"""The Engine's captured prefill (``serve.graph.CapturedStep``) on the CPU.

On the CPU a captured step runs uncaptured on its static buffers: the same
function that the card captures.  Through a stand-in graph whose replay
runs the captured body again and writes the capture's own outputs in place
(as a CUDA graph's replay rewrites its output buffers), on weights bridged
from a JAX ``init``:

* the captured prefill's logits and decode state, first call and replay,
  against JAX's ``make_prefill_step`` for one config of each family (dense,
  windowed and softcapped, MoE, SSM, hybrid, encoder-decoder), at the
  tolerance of tests/test_torch_engine.py (2e-3);
* a second prompt of the same layout overwrites the static batch and gives
  its own logits and state, in the capture's own buffers; a new prompt
  length makes a new captured prefill;
* launch accounting: a capture leaves ``ops.LAUNCHES`` / ``LAUNCH_SHAPES``
  as they were, each replay adds one prefill's counts;
* the layout key tells apart two DTensor batches that differ only in their
  placements (on a fake process group), and a static buffer refuses a
  tensor laid out otherwise.

Marked ``cuda`` (skipped without a card): capture and replay of the prefill
equal the eager prefill bit for bit on smoke configs, and a capture on a
mesh that syncs with the host raises.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.serve import make_prefill_step as jax_prefill_step
from repro_torch.kernels import ops
from repro_torch.serve import Engine, make_prefill_step
from repro_torch.serve.graph import CapturedStep, CudaGraph, layout, static_like
from test_torch_decode_graph import FAMILIES, StandInGraph, batch, bridged, to_torch

TOL = 2e-3  # tests/test_torch_engine.py's, the port against JAX in f32
MAX_LEN = 40


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke sizes: one torch thread each, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RerunGraph(StandInGraph):
    """A stand-in graph whose ``replay`` runs the captured body again and
    copies its outputs into the capture's, as a CUDA graph's replay
    rewrites its output buffers; the rerun's launch counts are undone (a
    replay's counts are the captured step's to add)."""

    def capture(self, body):
        self.body, self.out = body, body()
        return self.out

    def replay(self):
        super().replay()
        launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)
        for dst, src in zip(tree_leaves(self.out), tree_leaves(self.body())):
            dst.copy_(src)
        ops.LAUNCHES.update(launches)
        ops.LAUNCH_SHAPES.clear()
        ops.LAUNCH_SHAPES.update(shapes)


def state_pairs(state, jstate, path=""):
    """(path, port tensor, JAX array) over the port's decode state, each
    leaf beside the reference's at the same dict key or tuple position."""
    if isinstance(state, dict):
        assert sorted(state) == sorted(jstate), path
        for k in state:
            yield from state_pairs(state[k], jstate[k], f"{path}{k}.")
    elif isinstance(state, (tuple, list)):
        assert len(state) == len(jstate), path
        for i, (s, j) in enumerate(zip(state, jstate)):
            yield from state_pairs(s, j, f"{path}{i}.")
    else:
        yield path[:-1], state, np.asarray(jstate)


def jax_prefill(arch, b):
    jcfg, jparams, _ = bridged(arch)
    return jax.jit(jax_prefill_step(jcfg, MAX_LEN))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})


def assert_matches_jax(out, want):
    (logits, state), (jlogits, jstate) = out, want
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    for path, got, ref in state_pairs(state, jstate):
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL, err_msg=path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_captured_prefill_matches_jax(arch):
    """The captured prefill's first call (uncaptured, on the static batch)
    and its replay (the body again, into the capture's outputs) give JAX's
    prefill logits and decode state."""
    _, _, model = bridged(arch)
    b = batch(model.cfg, 2, 8)
    want = jax_prefill(arch, b)
    step = CapturedStep(make_prefill_step(model, MAX_LEN), to_torch(b), RerunGraph)
    assert_matches_jax(step(to_torch(b)), want)
    assert step.captured and step.graph.replays == 0
    again = step(to_torch(b))
    assert again is step.out and step.graph.replays == 1
    assert_matches_jax(again, want)


@pytest.mark.parametrize("arch", ["stablelm_12b", "mamba2_2p7b", "seamless_m4t_large_v2"])
def test_a_new_prompt_overwrites_the_static_batch(arch):
    """A second prompt of the same layout is copied into the static batch,
    and the replay gives its own logits and state (bit-equal to the eager
    prefill's), written into the capture's outputs; run again on the
    static batch without a copy, the step gives the same."""
    _, _, model = bridged(arch)
    prefill = make_prefill_step(model, MAX_LEN)
    first, second = to_torch(batch(model.cfg, 2, 8, seed=0)), to_torch(batch(model.cfg, 2, 8,
                                                                              seed=1))
    step = CapturedStep(prefill, first, RerunGraph)
    logits_first = step(first)[0].clone()
    logits, state = step(second)
    for k in second:
        assert torch.equal(step.inputs[k], second[k]) and step.inputs[k] is not second[k]
    want_logits, want_state = prefill(second)
    assert logits is step.out[0] and torch.equal(logits, want_logits)
    assert not torch.equal(logits, logits_first)
    for got, want in zip(tree_leaves(state), tree_leaves(want_state)):
        assert torch.equal(got, want)
    assert torch.equal(step.run()[0], want_logits)


def test_a_new_prompt_length_makes_a_new_capture():
    """One captured prefill per batch layout, the last one's kept: a prompt
    of 12 tokens after one of 8 makes a new capture, which replaces the
    first, and a prompt of 8 again makes another; the tokens are those of
    fresh Engines."""
    _, _, model = bridged("stablelm_12b")
    eng = Engine(model, max_len=MAX_LEN, device="cpu")
    made = []
    for S, seed in ((8, 0), (12, 1), (8, 2), (8, 3)):
        b = to_torch(batch(model.cfg, 2, S, seed))
        got = eng.generate(b, 3).tokens
        np.testing.assert_array_equal(
            got, Engine(model, max_len=MAX_LEN, device="cpu").generate(b, 3).tokens)
        (step,) = eng._prefills.values()
        assert tuple(step.inputs["tokens"].shape) == (2, S)
        made.append(step)
    assert len({id(step) for step in made[:3]}) == 3 and made[3] is made[2]
    assert len(eng._steps) == 1  # the decode state's layout is the prompt's either way


def counting_prefill(b):
    """A stand-in prefill whose Python counts launches as the kernel
    wrappers do: two flash_prefill calls and one ssd_intra_chunk."""
    ops.LAUNCHES["flash_prefill"] += 2
    ops.LAUNCHES["ssd_intra_chunk"] += 1
    ops.LAUNCH_SHAPES["flash_prefill", ("enc",)] += 2
    ops.LAUNCH_SHAPES["ssd_intra_chunk", ("chunk",)] += 1
    return b["tokens"].float()[:, -1:], {"pos": b["tokens"].new_full(b["tokens"].shape[:1], 3)}


def test_prefill_capture_leaves_launch_counts_and_each_replay_adds_a_prefill():
    ops.reset_launches()
    b = {"tokens": torch.ones(2, 3, dtype=torch.long)}
    step = CapturedStep(counting_prefill, b, StandInGraph)
    step(b)  # the first call runs uncaptured, then the capture
    assert step.captured and step.graph.replays == 0
    assert dict(ops.LAUNCHES) == {"flash_prefill": 2, "flash_decode": 0, "ssd_intra_chunk": 1}
    for n in (1, 2):
        step(b)
        assert step.graph.replays == step.replays == n
        assert dict(ops.LAUNCHES) == {"flash_prefill": 2 * (n + 1), "flash_decode": 0,
                                      "ssd_intra_chunk": n + 1}
        assert ops.LAUNCH_SHAPES == {("flash_prefill", ("enc",)): 2 * (n + 1),
                                     ("ssd_intra_chunk", ("chunk",)): n + 1}
    with pytest.raises(ValueError, match="layout"):
        step({"tokens": torch.ones(2, 4, dtype=torch.long)})
    ops.reset_launches()


@pytest.fixture
def fake_mesh():
    """A 2-rank mesh on a fake process group (this process rank 0)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import dryrun

    with dryrun.fake_world(2):
        yield DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("model",))


def test_layout_tells_dtensor_placements_apart(fake_mesh):
    """Two DTensor batches of one global shape, type and device, laid out
    by other placements, have distinct layouts, and neither is a plain
    tensor's; ``static_like`` keeps the mesh, placements and shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    split = DTensor.from_local(torch.zeros(2, 6, dtype=torch.long), fake_mesh, [Shard(0)],
                               run_check=False)
    whole = DTensor.from_local(torch.zeros(4, 6, dtype=torch.long), fake_mesh, [Replicate()],
                               run_check=False)
    assert split.shape == whole.shape == (4, 6)
    keys = {layout({"tokens": t}) for t in (split, whole, torch.zeros(4, 6, dtype=torch.long))}
    assert len(keys) == 3
    like = static_like(split)
    assert isinstance(like, DTensor) and like.placements == split.placements
    assert like.device_mesh == fake_mesh and like.shape == split.shape
    assert like.to_local().shape == (2, 6) and layout(like) == layout(split)


def test_a_static_buffer_refuses_other_placements(fake_mesh):
    """A captured step made for one layout refuses inputs laid out by other
    placements or another type (no silent redistribution or conversion),
    and copies a batch laid out alike into its buffer shard by shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    split = DTensor.from_local(torch.arange(12).reshape(2, 6), fake_mesh, [Shard(0)],
                               run_check=False)
    whole = DTensor.from_local(torch.zeros(4, 6, dtype=torch.long), fake_mesh, [Replicate()],
                               run_check=False)
    step = CapturedStep(lambda b: b["tokens"], {"tokens": split})
    for other in (whole, split.to(torch.int32)):
        with pytest.raises(ValueError, match="layout"):
            step({"tokens": other})
    again = DTensor.from_local(torch.arange(12, 24).reshape(2, 6), fake_mesh, [Shard(0)],
                               run_check=False)
    out = step({"tokens": again})
    assert out is step.inputs["tokens"] and out is not again
    assert torch.equal(out.to_local(), again.to_local())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_1p2b", "seamless_m4t_large_v2"])
def test_captured_prefill_bit_equal_eager_on_the_card(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = get_smoke_config(arch).replace(dtype="bfloat16")
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = Engine(model, max_len=MAX_LEN)
    eager = Engine(model, max_len=MAX_LEN, cuda_graph=False)
    for seed in (0, 0, 1):  # the capture, a replay, a replay of another prompt
        b = {k: v.to(cuda) for k, v in to_torch(batch(cfg, 2, 8, seed)).items()}
        if "enc_emb" in b:
            b["enc_emb"] = b["enc_emb"].bfloat16()
        for got, want in zip(tree_leaves(eng._prefill(b)), tree_leaves(eager._prefill(b))):
            assert torch.equal(got, want), seed
    (step,) = eng._prefills.values()
    assert step.captured and step.replays == 2


@pytest.mark.cuda
def test_a_failing_capture_on_a_mesh_raises(cuda):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1, 1), dtype=torch.int64),
                          mesh_dim_names=("pod", "data", "model"))
        x = DTensor.from_local(torch.ones(4, device=cuda), mesh, [Replicate()] * 3)

        def syncs(inputs):  # a host sync, which a capture refuses
            y = inputs * 2
            if y.to_local().sum().item() < 0:
                y = -y
            return y

        step = CapturedStep(syncs, x, CudaGraph)
        with pytest.raises(RuntimeError):
            step(x)
        assert not step.captured
    finally:
        dist.destroy_process_group()
