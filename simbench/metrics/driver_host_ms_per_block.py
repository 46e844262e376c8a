"""driver_host_ms_per_block: the traced window's time that no device
operation covers, over the solver blocks called in it (the batched driver's
host work and launch gaps, a block at a time)."""


def read(run):
    tl, rec = run.timeline, run.record
    if tl is None or rec.blocks <= 0:
        return None
    return (tl.window_s - tl.busy_s) / rec.blocks * 1e3
