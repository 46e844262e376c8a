"""driver_idle_ms_per_block: the traced window's idle device time during
which the port had a driver span open (``dse.batch``, ``dse.solve``,
``dse.materialize``) and no kernel-1 span, over the window's solver blocks
(``simbench/spans.py``)."""

from simbench.spans import idle_ms_per_block


def read(run):
    return idle_ms_per_block(run, "driver")
