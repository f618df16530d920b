"""Share of the traced window in which the device ran no kernel, copy or
memset (the union of the profiler's device intervals)."""


def read(run):
    t = run.summary
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
