"""decode_step_ms: the window's decode time (every gap between successive
tokens) over its decode steps."""

from perfbench import serving


def read(run):
    gaps = [s for _, _, s in serving.gaps_s(run.window)]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
