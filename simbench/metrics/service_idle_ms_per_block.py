"""service_idle_ms_per_block: the traced window's idle device time during
which the port had a sweep-service span open (``sweep.block``,
``sweep.shard``) and no driver or kernel-1 span, over the blocks the
scheduler assembled in the window (``simbench/spans.py``)."""

from simbench.spans import idle_ms_per_block


def read(run):
    return idle_ms_per_block(run, "service")
