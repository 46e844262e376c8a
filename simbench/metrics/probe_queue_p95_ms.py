"""probe_queue_p95_ms: the 95th percentile of the interactive-lane
requests' waits in the sweep service's queue, each from ``submit`` to the
block that took its first rows (the port's ``sweep.queued`` span, host
clock), over the requests submitted in the traced window no later than
the longest wait before its end, so that none of theirs can be missing
(``simbench/spans.queue_waits_s``). numpy's linear interpolation, as
``query_p95_ms``."""

import numpy as np

from simbench.spans import queue_waits_s


def read(run):
    waits = queue_waits_s(run)
    return float(np.percentile(waits, 95)) * 1e3 if waits is not None \
        else None
