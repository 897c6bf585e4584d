#!/usr/bin/env python3
"""Where the wall of ``chip_smoke.py``'s failover step goes beyond its epoch's median.

    python3 tools/failover_jitter_probe.py [--pad N] [--repeats R]

On one CUDA card: phase 8 (a) of ``chip_smoke.py`` (stablelm-12b at its
published widths, cut to 8 layers, trained 90 steps through the partition,
the crash and the failover in step 70), ``R`` times each with 0 and with
``N`` extra objects alive in the collector's heap (small lists, standing for
what a long process such as ``chip_smoke.py`` holds by phase 8), each once
with the heap as it is and once with it frozen (``gc.freeze``) before the
timed steps.  Prints one JSON line per run: the heap, the failover's step
and the next against their epoch's median, the collector's ms in each and in
all, its full passes, the steps over the gate, and the walls, host CPU and
collector ms, host ms in the train step's call and device span of the
steps that ran farthest above their median.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pad", type=int, default=3_000_000)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card, flush=True)
    for pad in (0, args.pad):
        held = [[i] for i in range(pad)]
        for rep in range(args.repeats):
            for freeze in (False, True):
                t0 = time.perf_counter()
                out = smoke.failover_phase(card, freeze=freeze, check=False)
                rows = out["steps"]
                med = out["ms_per_step_by_epoch"]
                far = sorted(rows, key=lambda r: r["ms"] / med[r["epoch"]], reverse=True)[:5]
                print(json.dumps(dict(
                    card=card, pad=pad, repeat=rep, frozen=freeze,
                    heap_objects=out["heap_objects"], seconds=time.perf_counter() - t0,
                    ms_per_step_by_epoch=med,
                    around_failover=[dict(step=s["step"], ms=s["ms"], ratio=s["ratio"],
                                          gc_ms=s["gc_ms"], cpu_ms=s["cpu_ms"],
                                          control_ms=s["control_ms"],
                                          step_fn_ms=s["step_fn_ms"], device_ms=s["device_ms"])
                                     for s in out["around_failover"]],
                    gc_ms_total=out["gc_ms_total"], gc_ms_max=out["gc_ms_max"],
                    gc_full=out["gc_full"],
                    over_gate=[r["step"] for r in rows
                               if r["ms"] / med[r["epoch"]] > smoke.STEP_RATIO_MAX],
                    farthest=[dict(step=r["step"], ratio=r["ms"] / med[r["epoch"]], ms=r["ms"],
                                   cpu_ms=r["cpu_ms"], gc_ms=r["gc_ms"], gc_full=r["gc_full"],
                                   step_fn_ms=r["step_fn_ms"], device_ms=r["device_ms"])
                              for r in far],
                    faults=out["faults"])), flush=True)
        del held
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
