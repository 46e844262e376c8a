"""The traced window: device and host intervals from the profiler, and GC.

``profiled`` profiles the measured window with ``torch.profiler`` (CPU and
CUDA activity); ``read_trace`` turns it into a :class:`Timeline`: every device
operation's interval, and every host-side operation's (the CPU ops and CUDA
runtime calls the profiler records), clipped to the window, on one clock.
Busy time is the length of the union of the device intervals, so it never
exceeds the window, whatever the profiler does to single kernels. Idle gaps
are named after the window by the host operations in progress inside them;
nothing runs beside the window but the profiler.

``GcClock`` records the time the interpreter spends in full (generation 2)
collections, from ``gc.callbacks``; it never triggers a collection.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW_MARK = "simbench.window"


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval of ``busy`` (merged) covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def short_name(name: str) -> str:
    """``void (anonymous namespace)::cross_pass_kernel<4>(int*, ...)`` ->
    ``cross_pass_kernel<4>``."""
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut].removeprefix("void ").strip()
    lt = name.find("<")
    if lt >= 0 and len(name) - lt > 8:      # long template arguments go
        name = name[:lt]
    return name[-80:]


# the name of idle time during which the profiler saw no host operation:
# Python of the program or the benchmark between profiled calls
HOST_CODE = "(host code between profiled calls)"


class Timeline:
    """Device operations of one traced window, in seconds from its start,
    and the host operations beside them."""

    def __init__(self, ops: List[Tuple[str, float, float]], window_s: float,
                 host: Sequence[Tuple[str, float, float]] = ()):
        self.window_s = window_s
        self.ops = ops                      # (short name, start, end)
        self.busy = merge([(s, e) for _n, s, e in ops])
        self.busy_s = sum(e - s for s, e in self.busy)
        self.idle = gaps(self.busy, 0.0, window_s)
        self.host = sorted(host, key=lambda h: h[1])

    def seconds_of(self, names: Sequence[str]) -> Optional[float]:
        """Summed device time of the operations whose name holds any of
        ``names``; None when none ran."""
        hits = [e - s for n, s, e in self.ops if any(x in n for x in names)]
        return sum(hits) if hits else None

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = Counter()
        for n, s, e in self.ops:
            by[n] += e - s
        return [[n, v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def top_idle(self, k: int = 10, lookback: int = 16) -> List[List]:
        """Idle device time summed by what the host was doing: each gap goes
        to the host operation in progress at its middle that started last
        (of the ``lookback`` that started last before it), or to
        ``HOST_CODE`` where none is."""
        if not self.idle:
            return []
        mid = np.array([(s + e) / 2 for s, e in self.idle])
        dur = np.array([e - s for s, e in self.idle])
        who = np.full(len(mid), -1)
        if self.host:
            start = np.array([h[1] for h in self.host])
            end = np.array([h[2] for h in self.host])
            last = np.searchsorted(start, mid, side="right") - 1
            for back in range(lookback):
                j = last - back
                hit = (who < 0) & (j >= 0) & (end[np.maximum(j, 0)] >= mid)
                who[hit] = j[hit]
        by: Dict[str, float] = Counter()
        for i, d in zip(who.tolist(), dur.tolist()):
            by[self.host[i][0] if i >= 0 else HOST_CODE] += d
        return [[n, v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def profiled():
    """Profile the body (CPU and CUDA activity), marking it as the window;
    yields the profiler, to be read by :func:`read_trace` afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            yield prof
            torch.cuda.synchronize()


def read_trace(prof) -> Optional[Timeline]:
    """The Timeline of a :func:`profiled` window, or None where the
    profiler saw no device operation in it."""
    import torch

    # the raw events: the profiler's event tree costs ~60 us an event
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e for e in events if e.name() == WINDOW_MARK]
    if not mark:
        return None
    w0 = mark[0].start_ns()
    w1 = w0 + mark[0].duration_ns()
    names: Dict[str, str] = {}
    ops, host = [], []
    for e in events:
        if e.is_user_annotation():
            continue
        s = max(e.start_ns(), w0)
        t = min(e.start_ns() + e.duration_ns(), w1)
        if t > s:
            raw = e.name()
            name = names.get(raw)
            if name is None:
                name = names[raw] = short_name(raw)
            span = (name, (s - w0) * 1e-9, (t - w0) * 1e-9)
            (ops if e.device_type() == cuda else host).append(span)
    if not ops:
        return None
    return Timeline(ops, (w1 - w0) * 1e-9, host)


class GcClock:
    """Seconds spent in generation-2 collections while installed."""

    def __init__(self):
        self.full_s = 0.0
        self.full_passes = 0
        self._t0: Optional[float] = None

    def _cb(self, phase: str, info: Dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.full_s += time.perf_counter() - self._t0
            self.full_passes += 1
            self._t0 = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)
