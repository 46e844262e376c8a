"""The readers of the port's spans (``simbench/spans.py``): the window's idle
device time put down to kernel 1, the driver, the service and the rest, and
a probe's wait in the queue. On synthetic timelines and spans, then on one
small CPU run of each cell under a CPU-only profiler."""
import importlib
import json
import sys
from typing import NamedTuple, Optional

import numpy as np
import pytest

from conftest import ROOT, small_run
from simbench import harness, spans, timeline

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NEW = ("kernel1_idle_ms_per_block", "driver_idle_ms_per_block",
       "service_idle_ms_per_block", "probe_queue_p95_ms")


class Span(NamedTuple):          # the fields of repro_torch.obs.Span
    name: str
    thread: int
    t0: int
    t1: int
    attrs: Optional[dict]


class _Run:
    """The parts of a harness Run that the readers read: a window that
    starts at 100 s on the host clock."""

    def __init__(self, tl=None, blocks=1):
        self.timeline = tl
        self.record = harness.Record()
        self.record.t0, self.record.t1 = 100.0, 100.0 + (
            tl.window_s if tl else 1.0)
        self.record.blocks = blocks


def _span(name, a, b, thread=1, **attrs):
    """A span from ``a`` to ``b`` seconds into the window of ``_Run``."""
    return Span(name, thread, int(round((100 + a) * 1e9)),
                int(round((100 + b) * 1e9)), attrs or None)


@pytest.fixture
def given(monkeypatch):
    def put(got):
        monkeypatch.setattr(spans, "recorded", lambda: got or None)
    return put


def _read(name, run):
    return harness.load_reader(name)(run)


def test_the_parts_add_up_to_the_idle_time(given):
    # busy 0.1-0.2 and 0.5-0.6 of a 1-s window: idle 0.8 s
    tl = timeline.Timeline([("k", 0.1, 0.2), ("k", 0.5, 0.6)], 1.0)
    given([_span("dse.batch", 0.0, 0.45), _span("kernel1.fixpoint", 0.05,
                                                  0.3),
           _span("sweep.block", 0.4, 0.9, thread=2),
           _span("sweep.queued", 0.0, 1.0, thread=3, lane="interactive"),
           _span("kernel1.fixpoint", -3.0, -2.0)])      # before the window
    run = _Run(tl, blocks=4)
    parts = spans.idle_parts(run)
    assert parts == pytest.approx({"kernel 1": 0.05 + 0.1,
                                   "driver": 0.05 + 0.1 + 0.05,
                                   "service": 0.05 + 0.3,
                                   "outside": 0.1})
    idle = _read("device_idle_pct", run) / 100 * tl.window_s
    assert sum(parts.values()) == pytest.approx(idle, rel=1e-12)
    assert _read("kernel1_idle_ms_per_block", run) == pytest.approx(37.5)
    assert _read("driver_idle_ms_per_block.served", run) == \
        pytest.approx(50.0)
    assert _read("service_idle_ms_per_block", run) == pytest.approx(87.5)


def test_kernel1_then_driver_then_service_where_threads_overlap(given):
    # nothing busy; on thread 1 a block holds the whole window, on thread 2
    # a driver span 0.2-0.8 and on thread 3 a kernel-1 span 0.5-0.9
    given([_span("sweep.block", 0.0, 1.0, thread=1),
           _span("dse.solve", 0.2, 0.8, thread=2),
           _span("kernel1.fixpoint", 0.5, 0.9, thread=3)])
    parts = spans.idle_parts(_Run(timeline.Timeline([], 1.0)))
    assert parts == pytest.approx({"kernel 1": 0.4, "driver": 0.3,
                                   "service": 0.3, "outside": 0.0})


def test_nothing_to_read_gives_none(given, monkeypatch):
    tl = timeline.Timeline([("k", 0.1, 0.2)], 1.0)
    given([])
    for name in NEW:
        assert _read(name, _Run(tl)) is None
    # spans, but none in the window
    given([_span("dse.solve", 2.0, 3.0)])
    assert _read("driver_idle_ms_per_block", _Run(tl)) is None
    # a port with no span recorder, as on a tree before it
    monkeypatch.undo()
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert spans.recorded() is None
    for name in NEW:
        assert _read(name, _Run(tl)) is None


def test_the_probe_tail_counts_interactive_requests_of_the_window(given):
    waits = np.linspace(0.01, 0.2, 40)
    got = [_span("sweep.queued", 0.5, 0.5 + w, lane="interactive")
           for w in waits]
    got += [_span("sweep.queued", 0.5, 0.9, lane="bulk"),
            _span("sweep.queued", -0.1, 0.7, lane="interactive"),
            _span("sweep.queued", 1.05, 1.5, lane="interactive")]
    given(got)
    run = _Run(timeline.Timeline([], 1.0))
    want = np.percentile(waits, 95) * 1e3
    assert _read("probe_queue_p95_ms", run) == pytest.approx(want, rel=1e-6)
    # submitted less than the longest wait (0.2 s) before the window's end,
    # a request could have waited past it unseen: such requests are left
    # out, whether their wait was seen or not
    given(got + [_span("sweep.queued", 0.85, 0.95, lane="interactive"),
                 _span("sweep.queued", 0.9, 1.0, lane="interactive")])
    assert _read("probe_queue_p95_ms", run) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_under_a_profiler_yields_every_new_metric(cell):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    obs.clear()
    run = small_run(cell)
    run.seconds = 1.5
    driver = importlib.import_module(
        f"simbench.entries.{run.mix['entry']}").Driver(run)
    try:
        driver.setup()
        with profile(activities=[ProfilerActivity.CPU]):
            driver.window(run.seconds)
        driver.drain()
    finally:
        driver.close()
    rec = run.record
    # the CPU lane has no device: the whole window is idle
    run.timeline = timeline.Timeline([], rec.t1 - rec.t0)
    want = [m["name"] for m in SPEC["per_layer"]
            if m["name"].split(".")[0] in NEW and cell in m["workloads"]]
    assert want
    for name in want:
        v = _read(name, run)
        assert v is not None and v >= 0, name
    parts = spans.idle_parts(run)
    assert sum(parts.values()) == pytest.approx(run.timeline.window_s,
                                                rel=1e-9)
    assert parts["kernel 1"] > 0
    obs.clear()
