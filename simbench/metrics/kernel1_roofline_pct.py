"""kernel1_roofline_pct: the least time the card's memory could move what
kernel 1 must (``simbench/costs.py``: inputs read once, the times written
once) at the published bandwidth (``simbench/peaks.py``), over kernel 1's
summed device time in the traced window."""

from simbench.costs import KERNEL1, kernel1_bytes
from simbench.peaks import PEAKS


def read(run):
    tl = run.timeline
    s = tl.seconds_of(KERNEL1) if tl is not None else None
    peak = PEAKS.get(run.device_kind)
    rec = run.record
    if not s or peak is None or rec.solved <= 0:
        return None
    nbytes = kernel1_bytes(run.design, rec.solved, rec.blocks)
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / s
