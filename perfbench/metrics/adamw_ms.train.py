"""adamw_ms.train: the median, over the train steps of the program's own
traced stretch (``program_spans``), of the ``train.update`` span's device
time: AdamW's update, between the span's CUDA events."""

import statistics

from perfbench import program_spans


def read(run):
    sp = program_spans.spans(run)
    times = sp and program_spans.device_times(sp, "train.update")
    return 1e3 * statistics.median(times) if times else None
