"""idle_pct.decode: the share of a call's decode stretch, from its first
decode step's entry to the call's end, in which the device runs no
captured decode step: 1 - the steps' time over the stretch, both on the
device's clock, in one call timed by CUDA events and not profiled (the
profiler costs the host ~20 ms a graph launch, so a traced stretch's gaps
are the profiler's).  A step is entered after its token's copy to the host,
so the device is idle when its entry is recorded; the graph launch's
latency counts as busy, sampling's argmax and the token's copy (tens of
microseconds a step) as idle."""

from perfbench import serving


def read(run):
    steps = serving.timed_steps(run.trace, "decode")
    if not steps:
        return None
    busy = sum(b - a for a, b in steps)
    return 100.0 * (1.0 - busy / (run.trace["timed"]["end"] - steps[0][0]))
