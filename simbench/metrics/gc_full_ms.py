"""gc_full_ms: host time in full (generation 2) collections during the
window, from a ``gc.callbacks`` hook; 0 where none ran. The harness never
collects or freezes around the window."""


def read(run):
    return run.gc.full_s * 1e3
