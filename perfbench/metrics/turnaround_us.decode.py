"""turnaround_us.decode: the median, over successive decode steps of the
program's own traced call (``program_spans``), of the device's time from
one decode replay's end event to the next one's start event: the host's
turn between two steps, while the device runs only the sampling.  On
standard error it is split at the ``engine.sample`` span's end event into
the sampling and the tokens' copy to the host, and the host's Python and
the next launch."""

import statistics
import sys

from perfbench import program_spans


def read(run):
    sp = program_spans.spans(run)
    pairs = sp and program_spans.turnarounds(sp)
    if not pairs:
        return None
    sample, rest = (statistics.median(p[i] for p in pairs) for i in (0, 1))
    print(f"perfbench: turnaround_us.decode: {len(pairs)} turns; medians: sampling and copy "
          f"{1e6 * sample:.2f} us, host and launch {1e6 * rest:.2f} us", file=sys.stderr)
    return 1e6 * statistics.median(a + b for a, b in pairs)
