"""Drive the full dry-run matrix: every (arch x shape) cell on each named
mesh (by default the reference's two: single-pod (16,16) and multi-pod
(2,16,16); ``1`` is one H100).

All on the CPU, on ``meta``, in this process: each cell is built and its
step counted once, then its bytes are laid out on each mesh in turn, each
mesh on a fake process group of its own size, destroyed before the next.
Results land in ``artifacts/dryrun/*.json``; a cell whose artifacts all
exist is skipped unless ``--force``.  Ends by printing the roofline table.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh 1 --mesh 16x16 ...]
      [--kind train|prefill|decode ...]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import List, Tuple

from ..configs import SHAPES, cells
from .dryrun import MESHES, artifact_path, run_cell
from .roofline import summarize_artifact

DEFAULT_MESHES = ["16x16", "2x16x16"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--mesh", action="append", choices=list(MESHES),
                    help=f"repeatable; default {' '.join(DEFAULT_MESHES)}")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--kind", action="append", choices=("train", "prefill", "decode"),
                    help="repeatable; the cells whose shape is of these kinds (default all)")
    args = ap.parse_args(argv)
    meshes = args.mesh or DEFAULT_MESHES
    os.makedirs(args.out, exist_ok=True)

    todo: List[Tuple[str, str, List[str]]] = []
    for arch, shape in cells():
        if args.only_arch and arch != args.only_arch:
            continue
        if args.kind and SHAPES[shape][2] not in args.kind:
            continue
        missing = [m for m in meshes
                   if args.force or not os.path.exists(artifact_path(args.out, arch, shape, m))]
        if missing:
            todo.append((arch, shape, missing))
    print(f"{len(todo)} cells to run on {meshes}")
    failures = 0
    for i, (arch, shape, missing) in enumerate(todo):
        print(f"--- [{i + 1}/{len(todo)}] {arch} {shape} {missing}", flush=True)
        t0 = time.time()
        try:
            run_cell(arch, shape, meshes=missing, out_dir=args.out)
        except Exception:  # one cell's fault is reported; the matrix goes on
            traceback.print_exc()
            failures += 1
        print(f"[{time.time() - t0:6.1f}s]", flush=True)
    print(f"done; {failures} failures")

    for f in sorted(os.listdir(args.out)):
        if f.endswith(".json"):
            with open(os.path.join(args.out, f)) as fh:
                art = json.load(fh)
            if art["mesh"] in meshes:
                print(summarize_artifact(art))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
