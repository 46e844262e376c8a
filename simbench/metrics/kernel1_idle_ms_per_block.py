"""kernel1_idle_ms_per_block: the traced window's idle device time during
which the port had a kernel-1 span open (``kernel1.fixpoint``, on any
thread: the host between the fixpoint's rounds, launching and waiting on
its flag), over the window's solver blocks (``simbench/spans.py``)."""

from simbench.spans import idle_ms_per_block


def read(run):
    return idle_ms_per_block(run, "kernel 1")
