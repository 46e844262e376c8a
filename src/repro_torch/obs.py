"""Spans of the port's own layers, kept in memory while a profiler runs.

A span is a named interval on one thread of the host's clock
(``time.perf_counter_ns``). Spans are recorded only while a
``torch.profiler`` session is on (the profiler's own global flag,
``torch.autograd.profiler._is_profiler_enabled``); at any other time a site
does nothing more than a single test of that flag. Nothing else turns
recording on.

The sites, and what each covers:

=====================  ===================================================
``sweep.queued``       a request's wait, from ``submit`` to the assembly
                       of the block that takes its first rows (``lane``)
``sweep.block``        ``BlockScheduler.step``: one block, from assembly
                       through delivery
``sweep.shard``        one shard's solve, on its worker thread or the
                       scheduler's
``dse.batch``          ``resimulate_batch``: dedup, solve and assembly
``dse.solve``          ``solve_block_status``
``dse.materialize``    ``materialize_block``
``kernel1.fixpoint``   ``kernels.maxplus.sparse.solve_chains``: the round
                       loop on the card, or its plain version on the CPU
                       (``rows``, ``rounds``, ``row_rounds``)
=====================  ===================================================

The recorder keeps the last :data:`CAP` spans; older ones are dropped and
counted (:func:`dropped`). There is no exporter: :func:`spans` hands them
over.

Shards of ``mode="process"`` run in worker processes: each records its own
spans (only under a profiler of its own), and none reaches this process.
"""
from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAP = 1 << 20


class Span(NamedTuple):
    name: str
    thread: int                  # threading.get_ident() of its thread
    t0: int                      # time.perf_counter_ns()
    t1: int
    attrs: Optional[dict]


_kept: deque = deque(maxlen=CAP)
_lock = threading.Lock()
_dropped = 0


def emit(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Record ``name`` from ``t0_ns`` to ``t1_ns`` (``perf_counter_ns``),
    on this thread."""
    global _dropped
    if not _profiler._is_profiler_enabled:
        return
    s = Span(name, threading.get_ident(), int(t0_ns), int(t1_ns),
             attrs or None)
    with _lock:
        if len(_kept) == _kept.maxlen:
            _dropped += 1
        _kept.append(s)


def traced(name: str):
    """Decorate a function so that each call is recorded as ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                emit(name, t0, time.perf_counter_ns())
        return call
    return wrap


def spans() -> List[Span]:
    """The spans kept so far, in the order they ended."""
    with _lock:
        return list(_kept)


def dropped() -> int:
    """Spans dropped past :data:`CAP`."""
    return _dropped


def clear() -> None:
    """Forget every span kept, and the count of those dropped."""
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0
