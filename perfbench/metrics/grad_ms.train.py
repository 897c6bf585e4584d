"""grad_ms.train: the median, over the train steps of the program's own
traced stretch (``program_spans``), of the step's ``train.grad`` spans'
device time summed: every microbatch's gradient and its bf16
accumulation, between the spans' CUDA events."""

import statistics

from perfbench import program_spans


def read(run):
    sp = program_spans.spans(run)
    sums = sp and program_spans.per_call(sp, "train.grad")
    return 1e3 * statistics.median(sums) if sums else None
