"""The readings that the output check's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... --seconds <s>

For each seed the cell's program runs as a run of the benchmark would, and
the reference reads what it produced (the lower reading); the reference
computed in fp8, put in the program's place, reads the same inputs (the
control, the upper reading), and for a training cell the reference with
half of each batch left out (a planted fault).  A served cell keeps one
Engine: each seed's weights are drawn into the same model, whose captured
steps stay valid, and a short window runs at the cell's own load.  One
JSON line a seed.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def calibrate(bench, workload: str, seeds, seconds: float, device: str = "cuda"):
    from perfbench.bench import Run

    cell = bench.cell(workload)
    kind = bench.module("traffic", cell.traffic["kind"])
    runner, rows = None, []
    for seed in seeds:
        if getattr(kind, "RESEEDS", False):
            # served: one Engine, each seed's weights drawn into its model,
            # a short window at the cell's load, the reference beside it
            if runner is None:
                runner = kind.Runner(bench, cell, seed, device)
                runner.setup()
            runner.reseed(seed)
            runner.window(seconds)
            e2e = {m["name"]: bench.module("metrics", m["name"]).read(
                Run(cell=cell, runner=runner, setup_s=0.0)) for m in cell.end_to_end
                if m["name"] != "setup_s"}
            row = {**runner.check(control=True), "window": e2e}
        else:
            # trained: each seed's state through its first steps, freed
            # before the reference
            runner = kind.Runner(bench, cell, seed, device)
            runner.setup()
            runner.release()
            row = runner.check(control=True)
        row = {"workload": workload, "seed": seed, **row}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if getattr(kind, "RESEEDS", False):
        runner.release()
    return rows


def main(argv):
    from perfbench.spec import Bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    calibrate(Bench(), args.workload, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
