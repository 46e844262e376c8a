"""device_idle_pct: the share of the traced window that no device operation
covers, from the window's own timeline (the union of the profiler's device
intervals, clipped to the window)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (tl.window_s - tl.busy_s) / tl.window_s
