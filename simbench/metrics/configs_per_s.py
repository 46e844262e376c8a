"""configs_per_s: every configuration answered inside the window, over the
window's length (host clock). In a served cell that counts every tenant's
rows."""


def read(run):
    rec = run.record
    span = rec.t1 - rec.t0
    return rec.answered_in_window() / span if span > 0 else None
