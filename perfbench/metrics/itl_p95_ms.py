"""itl_p95_ms: the 95th percentile of the gaps between successive tokens of
one request, over every gap of every request in the window."""

from perfbench import serving, stats


def read(run):
    gaps = serving.per_request((rows, s) for rows, _, s in serving.gaps_s(run.window))
    return 1e3 * stats.percentile(gaps, 95) if gaps else None
