"""idle_pct.prefill: the share of a prefill, from its call's start to its
first token's arrival (the first decode step's entry), in which the device
runs no captured prefill: 1 - the captured prefill's time over the
stretch, both on the device's clock, in the call timed by CUDA events (see
idle_pct.decode)."""

from perfbench import serving


def read(run):
    prefill = serving.timed_steps(run.trace, "prefill")
    decode = serving.timed_steps(run.trace, "decode")
    if not prefill:
        return None
    first = decode[0][0] if decode else run.trace["timed"]["end"]
    a, b = prefill[0]
    return 100.0 * (1.0 - (b - a) / first)
