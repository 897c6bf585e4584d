#!/usr/bin/env python3
"""Times versions of the bf16 ``flash_prefill`` kernel against each other in
one process on one card, in turns, beside ``scaled_dot_product_attention``.

    python3 tools/prefill_ab.py --tree old=<csrc dir> --tree new=src/repro_torch/csrc \\
        --order old,new,new,old

Each ``--tree NAME=DIR`` names a directory of CUDA sources (``csrc/`` of this
checkout, or of an older commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).  Each is built into its own library
with ``kernels/_build.py``; each version's output at every shape is held
against the plain version (``ref.flash_attention_ref``) before any timing;
a version that disagrees or fails to launch is reported and not timed.
Then the versions are timed in the order given, at the main paths' shapes
(stablelm-12b and zamba2-1.2b prefill, bf16, causal), with CUDA events as
``chip_smoke.time_ms`` does; the library call is timed first and last.
Prints one JSON line per timing and writes all of them, with the card's
name and power limit and ptxas's report of each version's prefill kernels,
to ``--out`` (``build/prefill_ab.json`` by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (B, S, H, K, hd), causal, no window, no softcap
SHAPES = {
    "stablelm_12b": (4, 512, 32, 8, 160),
    "zamba2_1p2b": (4, 1024, 32, 32, 64),
}


def launch(lib, q, k, v, out, scale):
    """One bf16 causal launch through a given library's C entry point."""
    import torch
    from repro_torch.kernels import _build

    B, Sq, H, hd = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.repro_flash_prefill(
        1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[2],
        Sq, k.shape[1], *strides, float(scale), 1, 0, 0.0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_prefill")


def main() -> int:
    import torch
    import torch.nn.functional as F
    from chip_smoke import card_line, close, time_ms
    from repro_torch.kernels import _build, ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR of CUDA sources")
    ap.add_argument("--order", required=True, help="comma-separated tree names, in turn")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=str(ROOT / "build" / "prefill_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    card = card_line()
    libs, report = {}, {}
    for name, path in trees.items():
        csrc = Path(path).resolve()
        libs[name] = _build.bind(_build.build(csrc))
        report[name] = [dict(e, args=_build.template_args(e["name"]))
                        for e in _build.resources(csrc) if "flash_prefill" in e["name"]]
        print(f"ptxas {name}:", json.dumps(report[name]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape_name, (B, S, H, K, hd) in SHAPES.items():
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (H, K, K))
        scale = hd ** -0.5
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       scale=scale, causal=True).transpose(1, 2)
        outs = {name: torch.empty_like(q) for name in libs}
        wrong = set()
        for name, lib in libs.items():
            try:
                launch(lib, q, k, v, outs[name], scale)
                err = close(outs[name], want, torch.bfloat16)
            except (AssertionError, RuntimeError) as exc:  # reported; not timed
                wrong.add(name)
                err = str(exc)
            rows.append(dict(shape=shape_name, tree=name, max_abs_err=err))
            print(json.dumps(rows[-1]), flush=True)

        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=True,
                                                  scale=scale, enable_gqa=True)

        sequence = ["library", *(n for n in order if n not in wrong), "library"]
        for turn, name in enumerate(sequence):
            if name == "library":
                ms = time_ms(library, iters=args.iters)
            else:
                lib, out = libs[name], outs[name]
                ms = time_ms(lambda: launch(lib, q, k, v, out, scale), iters=args.iters)
            rows.append(dict(shape=shape_name, turn=turn, tree=name, ms=ms))
            print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        dict(card=card, trees=trees, order=order, ptxas=report, rows=rows), indent=1))
    print(card, flush=True)
    return 1 if any(isinstance(r.get("max_abs_err"), str) for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
