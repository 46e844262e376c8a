"""The port's own spans in the traced window, and the window's idle device
time put down to the layer whose span was open.

The port records spans only while a profiler runs (``repro_torch.obs``),
each on the host clock ``time.perf_counter_ns``. ``Record.t0`` is taken on
that clock microseconds after the window mark that is the Timeline's zero,
so a span at ``t`` ns lies at ``t * 1e-9 - record.t0`` seconds on the
Timeline; spans are clipped to the window.

Each layer is a prefix of span names (the benchmark's own map, below).
An idle interval of the Timeline goes, piece by piece, to the first layer
of ``LAYERS`` with a span open on any thread over that piece: kernel 1
before the driver, the driver before the service. What no such span covers
is ``outside``: the benchmark's tenants, the interpreter's lock and its
collector. The four parts add up to the window's idle time. ``sweep.queued``
marks a request's wait in the queue, not work of the service, and takes
no part.

The rule asks only whether a span is open, on any thread. Where threads
overlap, as the service's shard threads and its scheduler do, kernel 1's
part holds host work of other threads done while a kernel-1 span is open,
and the driver's and the service's parts are lower bounds of the time
their own code held the card idle.

Every function returns None where there is nothing to read: a tree whose
port has no span recorder, or no span in the window.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import timeline

# layer, by the prefix of its span names, in the order idle time is given
LAYERS = (("kernel 1", "kernel1."), ("driver", "dse."), ("service", "sweep."))
OUTSIDE = "outside"
QUEUED = "sweep.queued"
INTERACTIVE = "interactive"


def recorded() -> Optional[list]:
    """Every span the port kept, or None where it keeps none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.spans() or None


def _ns(t_s: float) -> int:
    return int(round(t_s * 1e9))


def placed(run) -> Optional[List]:
    """``(span, start, end)`` of each span that overlaps the traced window,
    in seconds on its Timeline, clipped to the window."""
    tl, got = run.timeline, recorded()
    if tl is None or got is None:
        return None
    zero = _ns(run.record.t0)
    out = []
    for s in got:
        a = max((s.t0 - zero) * 1e-9, 0.0)
        b = min((s.t1 - zero) * 1e-9, tl.window_s)
        if b > a:
            out.append((s, a, b))
    return out or None


def _inside(lo: np.ndarray, hi: np.ndarray, at: np.ndarray) -> np.ndarray:
    """Whether each point of ``at`` lies inside one of the sorted disjoint
    intervals ``[lo, hi)``."""
    if not len(lo):
        return np.zeros(len(at), bool)
    j = np.searchsorted(lo, at, side="right") - 1
    return (j >= 0) & (at < hi[np.maximum(j, 0)])


def idle_parts(run) -> Optional[Dict[str, float]]:
    """Seconds of the window's idle device time by layer (``LAYERS``'
    names and ``OUTSIDE``)."""
    got = placed(run)
    if got is None:
        return None
    cover = {name: [] for name, _p in LAYERS}
    for s, a, b in got:
        if s.name == QUEUED:
            continue
        for name, prefix in LAYERS:
            if s.name.startswith(prefix):
                cover[name].append((a, b))
                break
    cover = {k: np.array(timeline.merge(v), float).reshape(-1, 2)
             for k, v in cover.items()}
    idle = np.array(run.timeline.idle, float).reshape(-1, 2)
    # cut the idle intervals at every span's ends: each piece then lies
    # wholly inside or outside each layer's spans
    pts = np.unique(np.concatenate([idle.ravel()]
                                   + [c.ravel() for c in cover.values()]))
    lo, hi = pts[:-1], pts[1:]
    mid = (lo + hi) / 2
    left = _inside(idle[:, 0], idle[:, 1], mid)
    parts = {}
    for name, _p in LAYERS:
        hit = left & _inside(cover[name][:, 0], cover[name][:, 1], mid)
        parts[name] = float(np.sum(hi[hit] - lo[hit]))
        left &= ~hit
    parts[OUTSIDE] = float(np.sum(hi[left] - lo[left]))
    return parts


def idle_ms_per_block(run, layer: str) -> Optional[float]:
    """``layer``'s part of the window's idle device time, in ms, over the
    window's solver blocks."""
    parts = idle_parts(run)
    if parts is None or run.record.blocks <= 0:
        return None
    return parts[layer] / run.record.blocks * 1e3


def queue_waits_s(run) -> Optional[np.ndarray]:
    """The ``sweep.queued`` wait of each interactive-lane request submitted
    in the window, in seconds, from the requests submitted no later than
    the longest such wait before the window's end.

    A wait is recorded only where it ends while the profiler runs, which
    stops just after ``Record.t1``; a request submitted later than that
    bound may have waited past the end unseen, and one submitted earlier
    only if it waited longer than every wait seen. So the late-submitted
    requests, whose long waits would be missing, are all left out."""
    got, rec = recorded(), run.record
    if got is None:
        return None
    t0, t1 = _ns(rec.t0), _ns(rec.t1)
    seen = np.array([(s.t0, s.t1 - s.t0) for s in got
                     if s.name == QUEUED and s.attrs
                     and s.attrs.get("lane") == INTERACTIVE
                     and t0 <= s.t0 <= t1], np.int64).reshape(-1, 2)
    keep = seen[:, 0] <= t1 - seen[:, 1].max(initial=0)
    return seen[keep, 1] * 1e-9 if keep.any() else None
