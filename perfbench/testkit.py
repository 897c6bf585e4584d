"""Throwaway benchmarks for the harness's tests: a copy of ``perfbench/``
beside a ``BENCHMARK.json`` that adds cells of tiny configurations, made of
new files and entries only (what a later change that adds a cell adds)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

from .spec import ROOT, Bench

SMALL = {  # same families, tiny widths, run on the CPU
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab=256),
    "ssm": dict(n_layers=3, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16),
}
SERVE = {"kind": "closed_batches", "batch": 3, "prompt": 32, "generate": 6, "check_requests": 8,
         "trace_decode_steps": 2}
TRAIN = {"batch": 4, "seq": 32, "microbatches": 2}


def _write(path: Path, data) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1) + "\n")


def throwaway(tmp: Path, limits: Optional[Dict[str, Dict]] = None) -> Bench:
    """A benchmark under ``tmp`` with the repo's cells and three more:
    ``tiny_dense.chat``, ``tiny_ssm.chat`` (the serving mix at tiny sizes)
    and ``tiny_stage.train``; ``limits`` overrides their output limits."""
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = {"tiny_dense": ("stablelm_12b", "dense"), "tiny_ssm": ("mamba2_2p7b", "ssm"),
           "tiny_stage": ("stablelm_12b_stage8", "dense")}
    for name, (base, family) in new.items():
        cfg = json.loads((ROOT / "perfbench" / "configs" / f"{base}.json").read_text())
        cfg["name"] = name
        cfg["model"].update(SMALL[family])
        if family == "dense":
            # sharper attention than at full width (q and k at 4 / sqrt(d)),
            # so that a tiny model's tokens depend on its cache
            cfg["init"].update(wq=["normal", 0.0, 0.5], wk=["normal", 0.0, 0.5])
        if name == "tiny_stage":
            # f32: at tiny widths bf16's rounding moves the gradients' norms
            # as far as the fp8 control does
            cfg["model"]["dtype"] = "float32"
        _write(tmp / "perfbench" / "configs" / f"{name}.json", cfg)
        data["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"perfbench/configs/{name}.json",
                                "reduced": sorted(SMALL[family]), "why": "a test's tiny copy"})
    _write(tmp / "perfbench" / "traffic" / "tiny_chat.json", SERVE)
    train = json.loads((ROOT / "perfbench" / "traffic" / "train_b8_s4096.json").read_text())
    _write(tmp / "perfbench" / "traffic" / "tiny_train.json", {**train, **TRAIN})
    cells = {"tiny_dense.chat": ("tiny_dense", "tiny_chat", "stablelm_12b.decode"),
             "tiny_ssm.chat": ("tiny_ssm", "tiny_chat", "stablelm_12b.decode"),
             "tiny_stage.train": ("tiny_stage", "tiny_train", "stablelm_12b.train")}
    base_limits = {"tiny_dense.chat": {"gap": 0.03}, "tiny_ssm.chat": {"gap": 0.01},
                   "tiny_stage.train": {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.1}}
    base_limits.update(limits or {})
    for cell, (config, traffic, like) in cells.items():
        data["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                  "why": "a test's tiny copy"})
        for m in data["end_to_end"] + data["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
        _write(tmp / "perfbench" / "workloads" / f"{cell}.json", {"limits": base_limits[cell]})
    _write(tmp / "BENCHMARK.json", data)
    return Bench(tmp)


def run_cpu(bench: Bench, workload: str, seed: int = 2**31 + 11, seconds: float = 3.0,
            trace: int = 0):
    """One run of a cell on the CPU, the look for a chip skipped."""
    from . import bench as harness

    args = harness.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)])
    return harness.run(bench, args, time.perf_counter(), device="cpu")
