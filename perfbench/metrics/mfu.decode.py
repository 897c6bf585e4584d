"""mfu.decode: the whole decode step's share of its roofline: the least
time of every decode step in the window (at its position; the larger of
its FLOPs over 989e12 FLOP/s and its bytes over 3.35e12 B/s) over their
measured time on the host's clock."""

from perfbench import roofline, serving


def read(run):
    gaps = serving.gaps_s(run.window)
    if not gaps:
        return None
    c, P = run.runner.cfg, run.runner.P
    least = sum(roofline.least_s(*roofline.decode_step_work(c, rows, P + d))[0]
                for rows, d, _ in gaps)
    return 100.0 * least / sum(s for _, _, s in gaps)
