"""The port's elastic trainer against the reference's, on the CPU.

The stablelm smoke config in f32, built as ``tests/coord/test_elastic.py``
builds it; the JAX trainer's initial state is bridged (copied) into the
port's.  Each schedule of that file runs through both trainers, which
must give equal events, equal ledgers (a checkpoint commit compared by its
step, each digest checked against its own manifest: the two packages'
masters part in the last bits, so their npz bytes differ), equal epochs,
pods, stall counts and durable steps, and losses within ``LOSS_RTOL``.
Then: the durable-step guard refuses, in both, a manifest that was saved
and not committed; the port restores the JAX trainer's committed
checkpoint and its state equals JAX's at that step; the train launcher
and the example run on the CPU.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import train as jtrain
from repro.configs import get_smoke_config as jax_smoke_config
from repro.coord import ElasticConfig as JaxElasticConfig
from repro.coord import ElasticTrainer as JaxElasticTrainer
from repro.launch import train as jax_launch_train
from repro.train import OptConfig as JaxOptConfig
from repro.train.data import DataConfig as JaxDataConfig
from repro_torch.configs import get_smoke_config
from repro_torch.coord import ElasticConfig, ElasticTrainer
from repro_torch.launch import train as launch_train
from repro_torch.train import OptConfig, checkpoint
from repro_torch.train.data import DataConfig
from repro_torch.weights import train_state_from_jax, train_state_to_jax
from test_torch_chip_smoke import smoke

ROOT = Path(__file__).resolve().parents[1]
# The train step's tolerance (chip_smoke.py's gate (a), whose reasons are
# beside it there), held over every step of each schedule.
LOSS_RTOL = smoke.PARITY_METRIC_RTOL


def make_pair(tmp_path, pods=("pod0",), checkpoint_every=8, commit_every=4):
    """(JAX trainer, port trainer) as tests/coord/test_elastic.py makes
    one, the port's state a copy of JAX's initial state."""
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=200)
    data = dict(seq_len=32, global_batch=4, seed=0)
    every = dict(checkpoint_every=checkpoint_every, commit_every=commit_every)
    jcfg = jax_smoke_config("stablelm_12b").replace(dtype="float32")
    jtr = JaxElasticTrainer(
        jcfg, JaxOptConfig(**kw), JaxDataConfig(vocab=jcfg.vocab, **data), pods=list(pods),
        ecfg=JaxElasticConfig(checkpoint_dir=str(tmp_path / "jax"), **every))
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    ptr = ElasticTrainer(
        cfg, OptConfig(**kw), DataConfig(vocab=cfg.vocab, **data), pods=list(pods),
        ecfg=ElasticConfig(checkpoint_dir=str(tmp_path / "torch"), **every), device="cpu")
    ptr.state = train_state_from_jax(jax.tree.map(np.array, jtr.state), cfg, device="cpu")
    return jtr, ptr


def ledger(trainer):
    """The ledger's entries as (class name, fields); a checkpoint commit as
    its step, once its digest is found equal to its own manifest's."""
    out = []
    for op in trainer.controller.ledger().history:
        if type(op).__name__ == "CheckpointCommit":
            path = os.path.join(trainer.ecfg.checkpoint_dir, f"step{op.step:08d}.manifest.json")
            with open(path) as f:
                files = json.load(f)["files"]
            digest = hashlib.sha256(json.dumps(files, sort_keys=True).encode()).hexdigest()[:16]
            assert op.manifest_digest == digest, op
            out.append(("CheckpointCommit", op.step))
        else:
            out.append((type(op).__name__, dataclasses.asdict(op)))
    return out


def check_same(jtr, ptr):
    assert ptr.events == jtr.events
    assert ledger(ptr) == ledger(jtr)
    assert (ptr.step, ptr.epoch, ptr.pods) == (jtr.step, jtr.epoch, jtr.pods)
    for c in (ptr.controller, jtr.controller):
        c.check_safety()
    assert ptr.controller.dep.leader.stall_count == jtr.controller.dep.leader.stall_count == 0
    assert ptr.controller.durable_step() == jtr.controller.durable_step()
    assert len(ptr.losses) == len(jtr.losses)
    assert np.isfinite(ptr.losses).all()
    np.testing.assert_allclose(ptr.losses, jtr.losses, rtol=LOSS_RTOL)


def state_equals(ptr, want):
    """The port's state, in JAX's tree layout, equals ``want`` exactly."""
    mine = train_state_to_jax(ptr.state)
    mine = jtrain.TrainState(mine.params, jtrain.optimizer.AdamState(*mine.opt), mine.step)
    jax.tree.map(np.testing.assert_array_equal, mine, want)


def progress(jtr, ptr):
    for tr in (jtr, ptr):
        tr.run(12)
        assert tr.controller.durable_step() >= 8


def scale_without_stall(jtr, ptr):
    for tr in (jtr, ptr):
        tr.run(6)
        assert tr.scale_to(["pod0", "pod1"])["activation_ms"] < 5.0
        tr.run(8)
        tr.scale_to(["pod0"])
        tr.run(4)
        assert tr.epoch == 2 and len(tr.pods) == 1


def failover_and_restore(jtr, ptr):
    for tr in (jtr, ptr):
        tr.run(10)
        tr.fail_and_replace("pod1", "pod2")
        tr.run(6)
        assert tr.restore_latest()
    snapshot = jax.tree.map(np.array, jtr.state)
    for tr in (jtr, ptr):
        tr.run(4)
    return snapshot


def loss_through_reconfigs(jtr, ptr):
    for tr in (jtr, ptr):
        tr.run(10)
        tr.scale_to(["pod0", "pod1"])
        tr.run(10)
        tr.scale_to(["pod0", "pod2"])
        tr.run(10)
        assert np.mean(tr.losses[-5:]) < np.mean(tr.losses[:5]) - 0.3


SCHEDULES = {progress: ("pod0",), scale_without_stall: ("pod0",),
             failover_and_restore: ("pod0", "pod1"), loss_through_reconfigs: ("pod0",)}


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: s.__name__)
def test_trainer_matches_reference(tmp_path, schedule):
    jtr, ptr = make_pair(tmp_path, SCHEDULES[schedule])
    snapshot = schedule(jtr, ptr)
    check_same(jtr, ptr)
    if snapshot is not None:
        # The port restores the JAX trainer's committed checkpoint (step 16)
        # and then holds JAX's state at that step, bit for bit.
        ptr.ecfg.checkpoint_dir = jtr.ecfg.checkpoint_dir
        assert ptr.restore_latest() and ptr.step == 16
        state_equals(ptr, snapshot)


def test_durable_step_guard(tmp_path):
    """A manifest saved and never committed is past the durable step: both
    trainers refuse it and stay where they are."""
    jtr, ptr = make_pair(tmp_path, checkpoint_every=4)
    for tr, save in ((jtr, jtrain.checkpoint.save), (ptr, checkpoint.save)):
        tr.run(6)
        assert tr.controller.durable_step() == 4
        save(tr.ecfg.checkpoint_dir, tr.step, tr.state)  # not committed
        assert not tr.restore_latest()
        assert tr.step == 6 and not any(e["t"] == "restore" for e in tr.events)
    check_same(jtr, ptr)


LAUNCH = ["--arch", "stablelm_12b", "--smoke", "--steps", "12", "--pods", "pod0,pod1,pod2",
          "--scale-at", "4=pod0,pod1,pod2,pod3", "--fail-at", "8=pod1:pod4"]


def summary(out):
    return json.loads(out[out.index("\n{") + 1:])


def test_launcher_matches_reference(tmp_path, capsys, monkeypatch):
    launch_train.main(LAUNCH + ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "t")])
    mine = summary(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH + ["--checkpoint-dir",
                                                           str(tmp_path / "j")])
    jax_launch_train.main()
    theirs = summary(capsys.readouterr().out)
    keys = ["ledger_last_step", "ledger_durable_step", "membership_epoch", "ledger_entries",
            "events"]
    assert {k: mine[k] for k in keys} == {k: theirs[k] for k in keys}
    assert mine["ledger_durable_step"] == 10 and mine["membership_epoch"] == 2
    assert np.isfinite(mine["final_loss"])


def test_launcher_loss_falls(tmp_path, capsys):
    launch_train.main(LAUNCH + ["--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if "loss=" in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_example_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/elastic_reconfiguration_torch.py"),
         "--device", "cpu", "--steps", "5"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "safety: OK"
    assert "membership epoch 3; ledger stalls: 0" in out.stdout
