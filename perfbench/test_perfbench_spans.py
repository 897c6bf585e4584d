"""The metrics that read the program's spans and counters (``program_spans``),
in whole runs of the tiny cells on the CPU: a traced run stays correct,
``capture_s`` reads the set-up's captures, the device readers find nothing
off the card, and the stretch they drive leaves every other metric, the
breakdown and the compared numbers as a run without them gives them."""

import json

import pytest
import torch

from perfbench import bench as harness
from perfbench import testkit

NEW = {"replay_ms.decode", "turnaround_us.decode", "replay_ms.prefill", "capture_s",
       "grad_ms.train", "adamw_ms.train"}
CELLS = ["tiny_dense.chat", "tiny_ssm.chat", "tiny_stage.train"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def benches(tmp_path_factory):
    """(the throwaway benchmark, the same without the six entries)."""
    with_new = testkit.throwaway(tmp_path_factory.mktemp("with"))
    without = testkit.throwaway(tmp_path_factory.mktemp("without"))
    assert NEW <= {m["name"] for m in without.data["per_layer"]}
    without.data["per_layer"] = [m for m in without.data["per_layer"] if m["name"] not in NEW]
    (without.root / "BENCHMARK.json").write_text(json.dumps(without.data, indent=1))
    return with_new, type(without)(without.root)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_is_correct_and_reads_the_counters(benches, cell):
    code, result = testkit.run_cpu(benches[0], cell, trace=1)
    assert code == 0 and result["correct"], result["compared"]
    got = NEW & set(result["metrics"])
    if cell.endswith(".chat"):  # off the card only the counter reads
        assert got == {"capture_s"} and result["metrics"]["capture_s"]["value"] > 0
    else:
        assert got == set()


@pytest.mark.parametrize("cell", CELLS)
def test_the_stretch_leaves_the_other_readings_as_they_were(benches, cell, monkeypatch):
    """Within the run, the other metrics and the breakdown read the same
    after the stretch as before it; the compared numbers and the
    breakdown's device operations equal a run's without the entries."""
    read = harness.read_metrics
    seen = {}

    def twice(bench, entries, run, required):
        if required:
            return read(bench, entries, run, required)
        old = [m for m in entries if m["name"] not in NEW]
        seen["before"] = (read(bench, old, run, False), run.runner.breakdown())
        out = read(bench, entries, run, False)
        assert hasattr(run, "program_spans") and run.program_spans
        seen["after"] = (read(bench, old, run, False), run.runner.breakdown())
        return out

    monkeypatch.setattr(harness, "read_metrics", twice)
    code, result = testkit.run_cpu(benches[0], cell, seed=9, trace=1)
    monkeypatch.undo()
    assert code == 0 and seen["before"] == seen["after"]
    code, plain = testkit.run_cpu(benches[1], cell, seed=9, trace=1)
    assert code == 0 and not NEW & set(plain["metrics"])
    assert result["compared"] == plain["compared"]
    assert set(result["metrics"]) - NEW == set(plain["metrics"])
    assert result["breakdown"]["device_ops"] == plain["breakdown"]["device_ops"]
    assert (result["attempted"] > 0, result["failed"]) == (plain["attempted"] > 0, plain["failed"])


@pytest.mark.parametrize("cell", ["tiny_ssm.chat", "tiny_stage.train"])
def test_a_program_without_the_tracer_reads_nothing_and_runs(benches, cell, monkeypatch):
    """A program that has no ``repro_torch.tracing`` (an older commit): the
    readers return None, drive nothing, and the run is correct."""
    import sys

    import repro_torch
    import repro_torch.serve  # the program, loaded with its tracer
    import repro_torch.train  # noqa: F401

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # the import fails
    code, result = testkit.run_cpu(benches[0], cell, trace=1)
    assert code == 0 and result["correct"], result["compared"]
    assert not NEW & set(result["metrics"])
