"""kernel1_us_per_config: the summed device time of kernel 1's three kernels
in the traced window, over the distinct configurations the window's blocks
solved (a direct call's ``n_unique``; the scheduler's ``rows_unique``)."""

from simbench.costs import KERNEL1


def read(run):
    tl = run.timeline
    s = tl.seconds_of(KERNEL1) if tl is not None else None
    if not s or run.record.solved <= 0:
        return None
    return s / run.record.solved * 1e6
