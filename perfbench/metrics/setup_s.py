"""setup_s: from the runner's start to the window's: import, weights and
state from the seed on the device, the kernel library from its cache, the
cell's own layouts captured, the warm-up calls."""


def read(run):
    return run.setup_s
