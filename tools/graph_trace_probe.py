#!/usr/bin/env python3
"""How often the profiler's device trace misses a kernel that runs early in a window.

    python3 tools/graph_trace_probe.py [--windows 80] [--variants plain,lead]
        [--archs llama4_scout_17b_a16e,stablelm_12b] [--out chiprun_out/graph_trace_probe.json]

On one CUDA card, for shallow models at published widths (batch 4): the
Engine's captured prefill and decode step, each profiled in ``--windows``
windows of one replay, in several variants of the window; and the eager
prefill the same way.  For each (model, step, variant) prints the windows
whose device trace shows fewer or more launches of a wrapper's kernel
than the host counted, and which kernel, so that a gate on the trace can
be set on the trace's own behaviour.  Variants: ``plain``
(the call, a synchronize), ``lead`` (20 ms inside the window before the
call) and ``settle`` (a synchronize and 50 ms before the window and after
the call).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch.trace_analysis import read_profile  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

SYMBOLS = {"flash_prefill": "flash_prefill_wgmma_kernel",
           "flash_decode": "flash_decode_bf16_kernel",
           "ssd_intra_chunk": "ssd_intra_chunk_bf16_kernel"}
CASES = {"llama4_scout_17b_a16e": (dict(n_layers=12), 512),
         "stablelm_12b": (dict(n_layers=8), 512)}


def window(fn, variant):
    torch.cuda.synchronize()
    if variant == "settle":
        time.sleep(0.05)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if variant == "lead":
            time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        if variant == "settle":
            time.sleep(0.05)
    reading = read_profile(prof, wall_ms=1.0)
    device = {n: reading.launches_of(s) for n, s in SYMBOLS.items()}
    return dict(ops.LAUNCHES), device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=80)
    ap.add_argument("--variants", default="plain,lead")
    ap.add_argument("--archs", default="llama4_scout_17b_a16e")
    ap.add_argument("--out", default="build/graph_trace_probe.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [dict(build_s=_build.timed_build())]
    print(json.dumps(rows[0]), flush=True)
    for arch in args.archs.split(","):
        cut, prompt = CASES[arch]
        cfg = get_config(arch).replace(**cut)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = get_model(cfg).init(gen, device="cuda")
        inputs = {"tokens": torch.randint(0, cfg.vocab, (4, prompt), generator=gen,
                                          device="cuda")}
        eng = Engine(model, max_len=prompt + 33)
        eager = Engine(model, max_len=prompt + 33, cuda_graph=False)
        eng.generate(inputs, 2)
        _, state = eager._prefill(inputs)
        tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
        steps = {"prefill graph": lambda: eng._prefill(inputs),
                 "decode graph": lambda: eng._decode(state, tok),
                 "prefill eager": lambda: eager._prefill(inputs)}
        for step, fn in steps.items():
            for variant in args.variants.split(","):
                misses, t0 = [], time.perf_counter()
                for w in range(args.windows):
                    host, device = window(fn, variant)
                    if host != device:
                        misses.append(dict(window=w, host=host, device=device))
                row = dict(arch=arch, cut=cut, step=step, variant=variant,
                           windows=args.windows, missed=len(misses), misses=misses[:5],
                           seconds=time.perf_counter() - t0)
                rows.append(row)
                print(json.dumps(row), flush=True)
        del model, eng, eager, state
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("graph_trace_probe: needs a CUDA device")
    main()
