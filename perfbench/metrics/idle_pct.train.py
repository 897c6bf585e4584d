"""idle_pct.train: the share of the traced train steps (their host ranges,
each ending in the loss read back) with no kernel on the device."""


def read(run):
    tr = run.trace
    if not tr:
        return None
    t = tr["trace"]
    steps = t.ranges.get("perfbench.step", [])
    wall = sum(b - a for a, b in steps)
    busy = sum(t.busy_s(a, b) for a, b in steps)
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
