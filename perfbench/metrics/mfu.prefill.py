"""mfu.prefill: the whole prefill's share of its roofline: its least time
(the larger of its FLOPs over 989e12 FLOP/s and its bytes over
3.35e12 B/s) over the window's measured prefill time."""

from perfbench import roofline, serving


def read(run):
    firsts = serving.first_token_s(run.window)
    if not firsts:
        return None
    r = run.runner
    least = sum(roofline.least_s(*roofline.prefill_work(r.cfg, rows, r.P))[0]
                for rows, _ in firsts)
    return 100.0 * least / sum(s for _, s in firsts)
