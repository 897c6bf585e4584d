"""gen_tok_s: every generated token that reached the host in the window,
over the window's whole time (prefills included)."""

from perfbench import serving


def read(run):
    return serving.tokens(run.window) / run.window.seconds
