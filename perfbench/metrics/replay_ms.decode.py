"""replay_ms.decode: the median, over the decode steps of the program's own
traced call (``program_spans``), of a captured decode step's replay on the
device: the ``step.replay`` span (kind ``decode``) between its CUDA events,
recorded on the stream just before and after the graph's replay."""

import statistics

from perfbench import program_spans


def read(run):
    sp = program_spans.spans(run)
    times = sp and program_spans.device_times(sp, "step.replay", "decode")
    return 1e3 * statistics.median(times) if times else None
