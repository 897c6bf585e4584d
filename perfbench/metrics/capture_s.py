"""capture_s: the host seconds of the program's captures, the counters
``capture_s.prefill`` + ``capture_s.decode`` (``repro_torch.tracing``):
each layout's eager first call and its capture.  A run's process captures
in its set-up only (the window and the traced calls replay the set-up's
layouts), so they are the set-up's."""

from perfbench import program_spans


def read(run):
    prefill = program_spans.counter("capture_s.prefill")
    return None if prefill is None else prefill + program_spans.counter("capture_s.decode")
