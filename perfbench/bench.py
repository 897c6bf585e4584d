"""One run of one cell: set-up, the measured window, the traced stretch, the
output check, and the result line.

``run`` returns (exit code, result); the result is ``None`` where the run
printed none.  A run needs as many CUDA devices as the cell asks for;
``device`` names another (the tests' CPU runs), which skips that look and,
unless ``check_modules``, the check of the process's modules (a test
process shares them with other tests; a test runs the harness in a process
of its own for that check).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import imports
from .spec import Bench, Cell


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    runner: Any  # the traffic kind's Runner: its config, window and trace records
    setup_s: float

    @property
    def window(self):
        return self.runner.window_record

    @property
    def trace(self) -> Optional[Dict[str, Any]]:
        return self.runner.trace_record


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _cuda_device(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        _say("perfbench: no CUDA device: torch.cuda.is_available() is false")
        return None
    if torch.cuda.device_count() < chips:
        _say(f"perfbench: the cell needs {chips} CUDA devices, "
             f"{torch.cuda.device_count()} are visible")
        return None
    return "cuda"


def _device_info(device: str, chips: int) -> Dict[str, Any]:
    import torch

    if device != "cuda":
        return {"platform": device, "kind": device, "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def read_metrics(bench: Bench, entries, run: Run, required: bool) -> Dict[str, Dict]:
    """Each metric's reader on ``run``; a reader that finds nothing returns
    None and its metric is left out (an end-to-end metric may not be)."""
    out = {}
    for m in entries:
        value = bench.module("metrics", m["name"]).read(run)
        if value is None:
            if required:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            _say(f"perfbench: {m['name']} found nothing to read")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compare(compared: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """Each number against its limit; a number missing or not finite (no
    request finished to compare) fails, and is written as null."""
    rows = {}
    for name, limit in limits.items():
        value = compared.get(name)
        rows[name] = {"value": value if value is not None and math.isfinite(value) else None,
                      "limit": limit}
    ok = all(r["value"] is not None and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows


def run(bench: Bench, args: argparse.Namespace, t_start: float,
        device: Optional[str] = None,
        check_modules: Optional[bool] = None) -> Tuple[int, Optional[Dict[str, Any]]]:
    cell = bench.cell(args.workload)
    if check_modules is None:  # run.py's process, not a test's that names a device
        check_modules = device is None
    if device is None:
        device = _cuda_device(cell.chips)
        if device is None:
            return 3, None
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kind = bench.module("traffic", cell.traffic["kind"])
    runner = kind.Runner(bench, cell, args.seed, device)
    t_ready = time.perf_counter()
    runner.setup()
    setup_s = time.perf_counter() - t_start
    laps = {"start and imports": t_ready - t_start, **runner.laps}
    _say("perfbench: set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.items()))
    runner.window(args.seconds)
    if args.trace:
        runner.trace()
    info = _device_info(device, cell.chips)
    run_view = Run(cell=cell, runner=runner, setup_s=setup_s)
    if args.trace:
        metrics = read_metrics(bench, cell.per_layer, run_view, required=False)
        busy, window, breakdown = runner.breakdown()
        info.update(busy_s=busy, window_s=window)
    else:
        metrics = read_metrics(bench, cell.end_to_end, run_view, required=True)
    attempted, failed = runner.counts()
    runner.release()
    correct, rows = compare(runner.check(), cell.limits["limits"])
    # after every file the run loads: the metrics' readers and the reference
    found = imports.forbidden() if check_modules else []
    if found:
        _say(f"perfbench: the run loaded forbidden modules: {', '.join(found)}")
        return 4, None
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if args.trace:
        result["breakdown"] = breakdown
    result["compared"] = rows
    for name, r in rows.items():
        _say(f"compared: {name} {r['value']!r} limit {r['limit']!r}")
    return 0, result


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    code, result = run(Bench(), args, t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
