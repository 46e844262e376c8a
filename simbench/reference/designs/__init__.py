"""Frozen copies of designs, one module per design function.

Each module gives ``fifos(**params)``, the FIFOs' names in declaration
order (the order of a depth row's columns), and ``modules(**params)``, the
module bodies as generator functions in the declaration order of the
original design. A body yields ops and is sent what each returns:

* ``("r", fifo)``: a blocking read; receives the value read;
* ``("w", fifo)`` or ``("w", fifo, value)``: a blocking write;
* ``("rnb", fifo)``: a non-blocking read; receives ``(ok, value)``
  (``value`` is None where it failed);
* ``("wnb", fifo, value)``: a non-blocking write; receives ``ok``;
* ``("full", fifo)``, ``("empty", fifo)``: a probe; receives a bool;
* ``("d", cycles)``: latency of the static schedule.

A copy that uses any op but the two-element blocking ones also gives
``depths(**params)``, the design's default depths: the base that the
program re-solves from, at which the reference counts its events. Bodies
must be re-runnable: every row runs them afresh. ``simulate.py`` states
what each op costs.

Besides the benchmarked designs, the directory holds copies of the
port's Type B/C designs (``designs/paper.py``), ``watchdog_pipe``,
``flowgnn_like`` and ``high_latency_pipe``, held to the port by
``simbench/tests/test_simbench_dynamic.py``, for cells to come.
"""
