"""Share of the traced stretch in which no operation ran on the device:
100 (1 - busy / wall), busy the union of the device operations' intervals
in the profiler's device-only trace, wall the stretch's host seconds."""


def read(run):
    t = run.trace
    if t is None or not t.done or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.wall_s)
