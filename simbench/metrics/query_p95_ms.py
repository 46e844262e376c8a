"""query_p95_ms: the 95th percentile of the open-loop requests' latencies,
each timed from when it was due to its assembled outcome (host clock), over
every request due in the window. numpy's linear interpolation between order
statistics."""

import numpy as np


def read(run):
    lat = [s for _due, s in run.record.latencies]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
