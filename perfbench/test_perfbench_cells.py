"""Whole runs of throwaway cells on the CPU (the look for a chip skipped): a
cell added by files and entries alone runs, a sound run is correct, a run
with the timed path broken underneath is not, the fp8 control is not, and
no run loads JAX or the JAX package.  The control at a cell's own size runs
on the card (marked ``cuda``)."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._pytree import tree_map

from perfbench import imports, testkit
from perfbench.calibrate import calibrate
from perfbench.spec import ROOT, Bench

SERVED = ["tiny_dense.chat", "tiny_ssm.chat"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    a run's window must hold several tiny calls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return testkit.throwaway(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", SERVED + ["tiny_stage.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_by_files_alone_runs_correct(bench, cell, trace):
    code, result = testkit.run_cpu(bench, cell, trace=trace)
    assert code == 0 and result["correct"], result["compared"]
    want = bench.cell(cell).per_layer if trace else bench.cell(cell).end_to_end
    if trace:  # on the CPU the device's readers find nothing to read
        assert set(result["metrics"]) <= {m["name"] for m in want}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"


def _frozen_state(monkeypatch):
    """A decode step that returns its state unchanged (its cache writes and
    its position lost)."""
    from repro_torch.models.lm import LM

    step = LM.decode_step

    def frozen(self, state, tokens):
        logits, _ = step(self, tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, state),
                         tokens)
        return logits, state

    monkeypatch.setattr(LM, "decode_step", frozen)


def _half_batch(monkeypatch):
    """A decode step that computes half of its rows and hands the other half
    their logits."""
    from repro_torch.models.lm import LM

    step = LM.decode_step

    def half(self, state, tokens):
        logits, new = step(self, state, tokens)
        h = logits.shape[0] // 2
        return torch.cat([logits[:logits.shape[0] - h], logits[:h]]), new

    monkeypatch.setattr(LM, "decode_step", half)


def _altered_token(monkeypatch):
    """The prefill's logits altered so that each row's first token is the
    one after its best."""
    from repro_torch.models.lm import LM

    prefill = LM.prefill

    def altered(self, tokens, max_len=None):
        logits, state = prefill(self, tokens, max_len)
        at = (logits.argmax(-1, keepdim=True) + 1) % logits.shape[-1]
        return logits + torch.zeros_like(logits).scatter_(-1, at, 1e4), state

    monkeypatch.setattr(LM, "prefill", altered)


@pytest.mark.parametrize("cell", SERVED)
@pytest.mark.parametrize("fault", [_frozen_state, _half_batch, _altered_token])
def test_a_broken_serving_path_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    code, result = testkit.run_cpu(bench, cell, seed=5)
    assert code == 0 and not result["correct"], result["compared"]


def _optimizer_skipped(monkeypatch):
    """A step that returns its state unchanged: the update does nothing."""
    from repro_torch.train import optimizer

    monkeypatch.setattr(optimizer, "update", lambda cfg, params, grads, state: (params, state, {}))


def _half_rows(monkeypatch):
    """Each microbatch's second half of rows left out, the mean taken over
    the rest."""
    from repro_torch.train import train_loop

    take = train_loop._microbatch

    def half(t, i, n):
        part = take(t, i, n)
        return part[: max(1, part.shape[0] // 2)]

    monkeypatch.setattr(train_loop, "_microbatch", half)


@pytest.mark.parametrize("fault", [_optimizer_skipped, _half_rows])
def test_a_broken_train_step_is_not_correct(bench, monkeypatch, fault):
    fault(monkeypatch)
    code, result = testkit.run_cpu(bench, "tiny_stage.train", seed=5)
    assert code == 0 and not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", SERVED + ["tiny_stage.train"])
def test_the_fp8_control_fails_where_the_program_passes(bench, cell):
    limits = bench.cell(cell).limits["limits"]
    for row in calibrate(bench, cell, [2, 3, 4], 1.5, "cpu"):
        assert all(row[k] <= lim for k, lim in limits.items()), row
        assert any(row["control_" + k] > lim for k, lim in limits.items()), row


def test_forbidden_modules_are_told_by_whole_top_level_name():
    assert imports.forbidden(["repro_torch.models", "reprox", "jaxx.y", "torch"]) == []
    assert imports.forbidden(["repro.core", "jaxlib.xla_client", "flax", "tools.x"]) == \
        ["flax", "jaxlib", "repro", "tools"]


def test_a_run_loads_no_jax_and_no_jax_package(bench, tmp_path):
    """A whole run in a fresh process; the result line and the loaded
    modules' top-level names."""
    code = (
        "import sys, json, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import bench as b, imports\n"
        "from perfbench.spec import Bench\n"
        "torch.set_num_threads(1)\n"
        "args = b.parse(['--workload', 'tiny_ssm.chat', '--seed', '7', '--seconds', '3'])\n"
        f"rc, result = b.run(Bench({str(bench.root)!r}), args, time.perf_counter(), device='cpu',\n"
        "                   check_modules=True)\n"
        "print(json.dumps({'rc': rc, 'correct': result['correct'],\n"
        "                  'loaded': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rc"] == 0 and line["correct"]
    assert "repro_torch" in line["loaded"]
    assert imports.forbidden(line["loaded"]) == []


PLANT = ("import sys, types\n"
         "sys.modules.setdefault({name!r}, types.ModuleType({name!r}))  # as an import leaves it\n")


@pytest.mark.parametrize("planted,module", [("metric", "jaxlib"), ("reference", "flax")])
def test_a_run_that_loads_a_forbidden_module_prints_no_result(tmp_path, planted, module):
    """A metric's reader or a reference added later that loads a forbidden
    module: the run, in a process of its own, exits 4 with no result."""
    bench = testkit.throwaway(tmp_path / "bench")
    files = bench.root / "perfbench"
    if planted == "metric":
        bench.data["per_layer"].append(
            {"name": "planted", "unit": "%", "better": "higher", "source": "program_counter",
             "layer": "Engine", "moves": "itl_p95_ms", "workloads": ["tiny_ssm.chat"]})
        (bench.root / "BENCHMARK.json").write_text(json.dumps(bench.data))
        (files / "metrics" / "planted.py").write_text(
            PLANT.format(name=module) + "\n\ndef read(run):\n    return None\n")
    else:
        ref = files / "reference" / "ssm.py"
        ref.write_text(ref.read_text() + "\n" + PLANT.format(name=module))
    code = (
        "import sys, json, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import bench as b\n"
        "from perfbench.spec import Bench\n"
        "torch.set_num_threads(1)\n"
        "args = b.parse(['--workload', 'tiny_ssm.chat', '--seed', '7', '--seconds', '2',\n"
        "                '--trace', '1'])\n"
        f"rc, result = b.run(Bench({str(bench.root)!r}), args, time.perf_counter(),\n"
        "                   device='cpu', check_modules=True)\n"
        "if result is not None:\n"
        "    print(json.dumps(result))\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 4, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert f"forbidden modules: {module}" in out.stderr


def test_without_a_chip_the_runner_prints_nothing_and_fails(tmp_path):
    """``run.py`` where no CUDA device is visible: a non-zero exit, no
    result line."""
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "stablelm_12b.decode", "--seed", "3", "--seconds", "1"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_every_benchmark_name_finds_its_files():
    b = Bench()
    for w in b.data["workloads"]:
        cell = b.cell(w["name"])
        b.module("traffic", cell.traffic["kind"])
        b.module("reference", cell.config["reference"])
        assert cell.limits["limits"]
    for m in b.data["end_to_end"] + b.data["per_layer"]:
        assert callable(b.module("metrics", m["name"]).read)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("mamba2_2p7b.prefill", 3.0)])
def test_the_fp8_control_fails_at_the_cells_size(cuda, cell, seconds):
    """On the card, at the cell's own size: the program within its limits,
    the fp8 control beyond one of them."""
    b = Bench()
    limits = b.cell(cell).limits["limits"]
    row = calibrate(b, cell, [12345], seconds, cuda)[0]
    assert all(row[k] <= lim for k, lim in limits.items()), row
    assert any(row["control_" + k] > lim for k, lim in limits.items()), row
