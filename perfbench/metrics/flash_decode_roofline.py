"""flash_decode_roofline: the traced decode steps' flash_decode calls: their
least time (PERF.md's byte and operation counts, at each step's cache
length) over their device time by kernel symbol.  Each call found in the
trace is counted at its step's length; the calls found and launched are
told on standard error (the profiler has been seen to drop a step's
kernels)."""

import sys

from perfbench import roofline, serving

SYMBOL = "flash_decode_bf16_kernel"


def read(run):
    tr = run.trace
    spans = serving.stretches(tr) if tr else None
    if spans is None:
        return None
    c, r = run.runner.cfg, run.runner
    least = measured = 0.0
    found = 0
    for d, (lo, hi) in enumerate(spans["steps"]):
        times = tr["trace"].kernel_calls(SYMBOL, lo, hi)
        one = roofline.least_s(*roofline.flash_decode_work(
            r.B, c.n_heads, c.n_kv_heads, c.head_dim, [r.P + d + 1] * r.B))[0]
        least += one * len(times)
        measured += sum(times)
        found += len(times)
    print(f"perfbench: {SYMBOL}: {found} calls in the trace, "
          f"{tr['launches']['flash_decode']} launched", file=sys.stderr)
    return 100.0 * least / measured if found else None
