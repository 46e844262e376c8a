"""The port's span recorder (``repro_torch.obs``): it records only under a
``torch.profiler`` session, its sites nest as documented, and the
oldest spans go past its cap. On the CPU lane, at a tiny design."""
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import resimulate_batch, simulate
from repro_torch.designs.typea import matmul_stream
from repro_torch.sweep import SweepService

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
