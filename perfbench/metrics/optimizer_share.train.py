"""optimizer_share.train: AdamW's share of the traced steps' device time:
the device time of the kernels launched under the ``perfbench.adamw``
range over the device busy time of the ``perfbench.step`` ranges."""


def read(run):
    tr = run.trace
    if not tr:
        return None
    t = tr["trace"]
    steps = t.ranges.get("perfbench.step", [])
    busy = sum(t.busy_s(a, b) for a, b in steps)
    adamw = t.range_device_s.get("perfbench.adamw", 0.0)
    if busy <= 0 or adamw <= 0:
        return None
    return 100.0 * adamw / busy
