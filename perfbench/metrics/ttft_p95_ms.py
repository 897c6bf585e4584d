"""ttft_p95_ms: the 95th percentile, over every request whose first token
came in the window, of the time from its generate call's start to that
token on the host."""

from perfbench import serving, stats


def read(run):
    firsts = serving.per_request(serving.first_token_s(run.window))
    return 1e3 * stats.percentile(firsts, 95) if firsts else None
