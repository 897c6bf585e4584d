"""prefill_ms: the window's time in prefills over their count, each from
its call's start to its first token on the host."""

from perfbench import serving


def read(run):
    firsts = [s for _, s in serving.first_token_s(run.window)]
    return 1e3 * sum(firsts) / len(firsts) if firsts else None
