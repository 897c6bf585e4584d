"""train_tok_s: tokens trained in the window over the window's whole time,
every step counted whole (the window ends with its last step)."""


def read(run):
    w = run.window
    return sum(n for _, _, n in w.steps) / w.seconds
