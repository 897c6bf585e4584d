"""CLI for the verification plane: ``python -m repro_torch.mc``.

Examples::

    python -m repro_torch.mc --list
    python -m repro_torch.mc --family single_decree --fault-budget 2
    python -m repro_torch.mc --family single_decree_mutated --expect-violation
    python -m repro_torch.mc --family mm_reconfig --preset quick --json out.json

Exit status: 0 when the run matches expectation (safe, or violating with
``--expect-violation``), 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

from repro_torch.core import mc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.mc",
        description="Bounded model checking over the deterministic simulator.",
    )
    ap.add_argument("--family", default="single_decree", help="model family (see --list)")
    ap.add_argument("--list", action="store_true", help="list model families and exit")
    ap.add_argument("--preset", choices=sorted(mc.PRESETS), help="bound preset")
    ap.add_argument("--depth", type=int, help="max events per trace")
    ap.add_argument("--states", type=int, help="max states to expand")
    ap.add_argument("--fault-budget", type=int, help="fault choices per trace")
    ap.add_argument(
        "--faults",
        help=f"comma-separated fault kinds (of {','.join(mc.FAULT_KINDS)})",
    )
    ap.add_argument("--timer-budget", type=int, help="timer fires per trace")
    ap.add_argument("--no-dpor", action="store_true", help="disable sleep-set DPOR")
    ap.add_argument(
        "--no-fingerprints", action="store_true", help="disable state-fingerprint pruning"
    )
    ap.add_argument(
        "--no-shrink", action="store_true", help="skip ddmin counterexample shrinking"
    )
    ap.add_argument("--json", metavar="PATH", help="write the MCResult as JSON")
    ap.add_argument(
        "--counterexample-dir",
        metavar="DIR",
        help="write counterexample + shrunk schedules as text files",
    )
    ap.add_argument(
        "--expect-violation",
        action="store_true",
        help="invert exit status: 0 iff a violation was found (self-tests)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(mc.FAMILIES):
            fam = mc.FAMILIES[name]
            print(f"{name:24s} {fam.doc}")
        return 0

    cfg = mc.PRESETS[args.preset] if args.preset else mc.MCConfig()
    over = {}
    if args.depth is not None:
        over["max_depth"] = args.depth
    if args.states is not None:
        over["max_states"] = args.states
    if args.fault_budget is not None:
        over["fault_budget"] = args.fault_budget
    if args.faults is not None:
        kinds = tuple(k for k in args.faults.split(",") if k)
        bad = [k for k in kinds if k not in mc.FAULT_KINDS]
        if bad:
            ap.error(f"unknown fault kinds {bad} (of {mc.FAULT_KINDS})")
        over["faults"] = kinds
    if args.timer_budget is not None:
        over["timer_budget"] = args.timer_budget
    if args.no_dpor:
        over["dpor"] = False
    if args.no_fingerprints:
        over["fingerprints"] = False
    if args.no_shrink:
        over["shrink"] = False
    if over:
        cfg = replace(cfg, **over)

    res = mc.explore(args.family, cfg)

    print(
        f"[mc] family={res.family} states={res.states} "
        f"transitions={res.transitions} terminals={res.terminals} "
        f"replays={res.replays} fp_hits={res.fingerprint_hits} "
        f"sleep_skipped={res.sleep_skipped} complete={res.complete} "
        f"wall={res.wall:.2f}s ({res.states_per_sec:.0f} states/s)"
    )
    if res.found:
        print(f"[mc] VIOLATION: {res.violation}")
        print(f"[mc] {res.replay_line()}")
        if res.shrunk is not None:
            print(
                f"[mc] SHRUNK ({len(res.shrunk.events)}/"
                f"{len(res.counterexample.events)} events): "
                f"MC-REPLAY (family={res.family!r}, schedule={res.shrunk!r})"
            )
    else:
        print("[mc] no violation found within bounds")

    if args.json:
        Path(args.json).write_text(json.dumps(res.to_json(), indent=2) + "\n")
        print(f"[mc] wrote {args.json}")
    if args.counterexample_dir and res.found:
        d = Path(args.counterexample_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{res.family}.counterexample.txt").write_text(
            res.replay_line() + "\n"
        )
        if res.shrunk is not None:
            (d / f"{res.family}.shrunk.txt").write_text(
                f"MC-REPLAY (family={res.family!r}, schedule={res.shrunk!r})\n"
            )
        print(f"[mc] wrote counterexamples under {d}")

    ok = res.found if args.expect_violation else not res.found
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
