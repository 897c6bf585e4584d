"""mfu.train: the window's model FLOPs (6 x matmul weights a token plus
attention's forward and backward, no recomputation) over its time x
989e12 FLOP/s."""

from perfbench import roofline


def read(run):
    r, w = run.runner, run.window
    flops = len(w.steps) * roofline.train_flops(r.cfg, r.B, r.S)
    return 100.0 * flops / (w.seconds * roofline.PEAK_FLOPS)
