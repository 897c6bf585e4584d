"""ssd_intra_chunk_roofline: the traced prefill's ssd_intra_chunk calls (one
a layer, all of one shape): their least time (PERF.md's byte and operation
counts) over their device time by kernel symbol; the calls found and
launched are told on standard error."""

import sys

from perfbench import roofline, serving

SYMBOL = "ssd_intra_chunk_bf16_kernel"


def read(run):
    tr = run.trace
    spans = serving.stretches(tr) if tr else None
    if spans is None:
        return None
    times = tr["trace"].kernel_calls(SYMBOL, *spans["prefill"])
    print(f"perfbench: {SYMBOL}: {len(times)} calls in the trace, "
          f"{tr['launches']['ssd_intra_chunk']} launched", file=sys.stderr)
    if not times:
        return None
    c, r = run.runner.cfg, run.runner
    one = roofline.least_s(*roofline.ssd_intra_chunk_work(
        r.B, r.P, c.n_ssm_heads, c.ssm_head_dim, c.ssm_state, min(c.ssm_chunk, r.P)))[0]
    return 100.0 * one * len(times) / sum(times)
