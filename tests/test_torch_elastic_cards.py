"""The elastic trainer on several ranks, on the CPU.

``tools/elastic_cards.py --device cpu --smoke``: 4 gloo ranks, one pod a
rank, through phase 6's schedule against one process; it exits 0, its
checks (a)-(d) hold, and its events equal (but the mesh's device counts)
those of the single-process run, which ``tests/test_torch_elastic.py``
holds equal to the JAX trainer's.  ``launch/train.py`` under ``torchrun``
on 2 gloo ranks: it meshes both ranks, only rank 0 prints, and its final
JSON equals the single-process run's (but the device counts).  Each runs
in a subprocess with its own timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke as smoke
from repro_torch.launch import train as launch_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL_TIMEOUT_S = 180
LAUNCH = ["--arch", "stablelm_12b", "--smoke", "--device", "cpu", "--steps", "12",
          "--pods", "pod0,pod1", "--fail-at", "4=pod1:pod2", "--scale-at", "8=pod0"]


def run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=TOOL_TIMEOUT_S)


def bare(events):
    return [{k: v for k, v in e.items() if k != "devices"} for e in events]


def test_elastic_cards_on_4_gloo_ranks(tmp_path):
    out = tmp_path / "elastic_cards.json"
    r = run(["tools/elastic_cards.py", "--device", "cpu", "--smoke", "--out", str(out)],
            tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got["faults"] == [] and got["world"] == 4
    # (a) pods on cards 0-2, card 3 joins, leaves, pod4 takes pod2's card
    assert got["devices"] == [3, 4, 3, 3]
    four = got["four_cards"]
    assert four["control"]["stall_count"] == 0 and four["control"]["durable_step"] == 10
    # (b) three re-meshes, each exact
    assert [r["exact"] for r in four["remeshes"]] == [True] * 3
    # (c) every step's loss against one card's
    assert len(got["loss_rel"]) == 20 and max(got["loss_rel"]) <= got["loss_gate"]
    # (d) the round trip on the ranks
    assert four["restored_digests"] == four["saved_digests"]
    assert got["replay_loss_rel"] <= smoke.REPLAY_LOSS_RTOL
    assert len(got["rss"]) == 8 and all(r["peak_gb"] <= r["bound_gb"] for r in got["rss"])
    # the events of the single-process port run (phase 6's, in a process
    # with no group, pods logical on one device)
    one = got["one_card"]
    assert [e["devices"] for e in one["events"] if e["t"] == "remesh"] == [1] * 4
    assert bare(four["events"]) == bare(one["events"])


def summary(text):
    return json.loads(text[text.index("\n{") + 1:])


def test_launcher_under_torchrun_meshes_both_ranks(tmp_path, capsys):
    r = run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
             "-m", "repro_torch.launch.train", *LAUNCH,
             "--checkpoint-dir", str(tmp_path / "ranks")], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    launch_train.main(LAUNCH + ["--checkpoint-dir", str(tmp_path / "one")])
    single = capsys.readouterr().out
    assert r.stdout.count('"final_loss"') == 1  # only rank 0 prints
    assert [line.split(" loss=")[0] for line in r.stdout.splitlines() if line.startswith("[")] == [
        line.split(" loss=")[0] for line in single.splitlines() if line.startswith("[")]
    mine, theirs = summary(r.stdout), summary(single)
    remesh = [e["devices"] for e in mine["events"] if e["t"] == "remesh"]
    assert remesh == [2, 2, 2]  # (2, 1), (2, 1), then (1, 2): both ranks every epoch
    assert [e["devices"] for e in theirs["events"] if e["t"] == "remesh"] == [1, 1, 1]
    assert bare(mine["events"]) == bare(theirs["events"])
    for k in ("ledger_last_step", "ledger_durable_step", "membership_epoch", "ledger_entries"):
        assert mine[k] == theirs[k], k
