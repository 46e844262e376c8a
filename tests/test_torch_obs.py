"""The port's span recorder (``repro_torch.obs``): it records only under a
``torch.profiler`` session, its sites nest as documented, and the
oldest spans go past its cap; kernel 1's span carries its row-rounds, which
the benchmark's reader ``kernel1_row_rounds_per_config`` reads. On the CPU
lane, at a tiny design."""
import sys
import threading
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import compile_graph, resimulate_batch, simulate
from repro_torch.designs.typea import matmul_stream
from repro_torch.sweep import SweepService

ROOT = Path(__file__).resolve().parents[1]
NAMES = {"sweep.queued", "sweep.block", "sweep.shard", "dse.batch",
         "dse.solve", "dse.materialize", "kernel1.fixpoint"}


@pytest.fixture(scope="module")
def base():
    return simulate(matmul_stream(m=2, k=2, n=2))


@pytest.fixture(autouse=True)
def fresh():
    obs.clear()
    yield
    obs.clear()


def _rows(n, seed):
    grid = np.stack(np.meshgrid(*[np.arange(1, 7)] * 3), -1).reshape(-1, 3)
    return np.random.default_rng(seed).permutation(grid)[:n]


def _drive(base):
    """One direct batch, then a bulk and an interactive request through a
    two-shard service, stepped on this thread."""
    resimulate_batch(base, _rows(24, 1), device="cpu")
    svc = SweepService(device="cpu", shards=2, mode="thread", block=32,
                       autostart=False)
    try:
        svc.warm(base)
        bulk = svc.submit(base, _rows(48, 2))
        probe = svc.submit(base, _rows(2, 3))
        while svc.step():
            pass
        assert len(bulk.result().cycles) == 48
        assert len(probe.result().cycles) == 2
    finally:
        svc.close()


def _inside(s, outer, same_thread=True):
    """Whether span ``s`` lies within one of the spans ``outer`` (on its
    own thread, where ``same_thread``)."""
    return any(o.t0 <= s.t0 and s.t1 <= o.t1
               and (o.thread == s.thread or not same_thread) for o in outer)


def test_the_flag_is_the_profilers_own():
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag() is True
    assert flag() is False
    # off, a site records nothing
    twice = obs.traced("a")(lambda x: 2 * x)
    assert twice(3) == 6
    obs.emit("a", 0, 1)
    assert obs.spans() == []


def test_nothing_is_recorded_without_a_profiler(base):
    _drive(base)
    assert obs.spans() == [] and obs.dropped() == 0


def test_the_sites_nest_as_documented(base):
    with profile(activities=[ProfilerActivity.CPU]):
        _drive(base)
    got = obs.spans()
    assert {s.name for s in got} == NAMES
    by = {n: [s for s in got if s.name == n] for n in NAMES}
    for s in got:
        assert s.t0 <= s.t1
    # each call lies within its caller, on the caller's thread; a shard
    # lies within its block, on a worker thread of the pool
    for s in by["kernel1.fixpoint"]:
        assert _inside(s, by["dse.solve"]), s
    for s in by["dse.solve"]:
        assert _inside(s, by["sweep.shard"] + by["dse.batch"]), s
    for s in by["dse.materialize"]:
        assert _inside(s, by["sweep.block"] + by["dse.batch"]), s
    for s in by["sweep.shard"]:
        assert _inside(s, by["sweep.block"], same_thread=False), s
    assert len(by["dse.batch"]) == 1 and len(by["sweep.block"]) >= 2
    assert ({s.thread for s in by["sweep.shard"]}
            - {s.thread for s in by["sweep.block"]})
    # each request waits once, in its own lane, up to the assembly of a
    # block: its wait ends within that block's span
    queued = by["sweep.queued"]
    assert sorted(s.attrs["lane"] for s in queued) == ["bulk",
                                                       "interactive"]
    for q in queued:
        assert q.t0 < q.t1
        assert _inside(type(q)(q.name, q.thread, q.t1, q.t1, None),
                       by["sweep.block"]), q


def test_a_call_that_raises_is_recorded():
    @obs.traced("boom")
    def boom():
        raise ValueError("boom")

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            boom()
    assert [s.name for s in obs.spans()] == ["boom"]


def test_past_the_cap_the_oldest_spans_go_and_are_counted(monkeypatch):
    monkeypatch.setattr(obs, "_kept", deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            obs.emit(f"s{i}", i, i + 1)
        obs.traced("last")(lambda: None)()
    got = obs.spans()
    assert [s.name for s in got] == ["s4", "s5", "s6", "last"]
    assert obs.dropped() == 4
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_threads_lose_no_span_and_no_drop_count(monkeypatch):
    monkeypatch.setattr(obs, "_kept", deque(maxlen=1000))
    n_threads, each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            workers = [threading.Thread(
                target=lambda: [obs.emit("t", 0, 1) for _ in range(each)])
                for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert len(obs.spans()) == 1000
    assert obs.dropped() == n_threads * each - 1000


def test_kernel1_span_carries_rows_rounds_and_row_rounds(base):
    import repro_torch.core.dse as tdse
    from repro_torch.kernels.maxplus import sparse

    g = compile_graph(base.graph)
    arr = tdse._sparse_arrays(tdse._batch_arrays(g), "cpu")
    D = torch.from_numpy(_rows(24, 4).astype(np.int32))
    with profile(activities=[ProfilerActivity.CPU]):
        _t, _c, rounds = sparse.solve_chains(arr, D)
    got = obs.spans()
    assert [s.name for s in got] == ["kernel1.fixpoint"]
    # the plain version runs every round over all K rows
    assert got[0].attrs == {"rows": 24, "rounds": rounds,
                            "row_rounds": 24 * rounds}
    assert rounds > 0



def test_a_kernel1_call_that_raises_is_recorded(base):
    import repro_torch.core.dse as tdse
    from repro_torch.kernels.maxplus import sparse

    g = compile_graph(base.graph)
    arr = tdse._sparse_arrays(tdse._batch_arrays(g), "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="int32"):
            sparse.solve_chains(arr, torch.ones((2, 3), dtype=torch.int64))
    got = obs.spans()
    assert [s.name for s in got] == ["kernel1.fixpoint"]
    assert got[0].attrs == {"rows": 0, "rounds": 0, "row_rounds": 0}


@pytest.mark.parametrize("name", ["kernel1_row_rounds_per_config",
                                  "kernel1_row_rounds_per_config.served"])
def test_the_row_rounds_reader_sums_the_windows_spans(monkeypatch, name):
    monkeypatch.syspath_prepend(str(ROOT))
    from simbench import harness, spans, timeline

    run = SimpleNamespace(timeline=timeline.Timeline([], 1.0),
                          record=harness.Record())
    run.record.t0, run.record.t1, run.record.solved = 100.0, 101.0, 2048
    at = lambda x: int(round((100 + x) * 1e9))            # noqa: E731
    got = [obs.Span("kernel1.fixpoint", 1, at(0.1), at(0.4),
                    {"rows": 1024, "rounds": 8191, "row_rounds": 500_000}),
           obs.Span("kernel1.fixpoint", 2, at(0.5), at(0.9),
                    {"rows": 1024, "rounds": 8191, "row_rounds": 524_288}),
           obs.Span("kernel1.fixpoint", 1, at(-2.0), at(-1.0),  # before it
                    {"rows": 1024, "rounds": 3, "row_rounds": 3072}),
           obs.Span("dse.batch", 1, at(0.0), at(0.95), None)]
    monkeypatch.setattr(spans, "recorded", lambda: got)
    read = harness.load_reader(name)
    assert read(run) == pytest.approx((500_000 + 524_288) / 2048)
    # spans without the attribute, as a port before it records them
    monkeypatch.setattr(spans, "recorded", lambda: [
        s._replace(attrs=None) if s.name == "kernel1.fixpoint" else s
        for s in got])
    assert read(run) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert read(run) is None
