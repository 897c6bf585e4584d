"""replay_ms.prefill: the captured prefill's replay on the device in the
program's own traced call (``program_spans``): the ``step.replay`` span
(kind ``prefill``) between its CUDA events; the median where there are
several."""

import statistics

from perfbench import program_spans


def read(run):
    sp = program_spans.spans(run)
    times = sp and program_spans.device_times(sp, "step.replay", "prefill")
    return 1e3 * statistics.median(times) if times else None
