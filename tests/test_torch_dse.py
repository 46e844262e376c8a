"""PyTorch port, batched depth re-solve: ``resimulate_batch`` and
``solve_block_status`` against the reference's ``backend="numpy"``.

The port's device lanes (``"cuda"``: the sparse fixpoint, kernel 1;
``"cuda_dense"``: the dense sweep, kernel 2) run here with
``device="cpu"``, i.e. through their plain PyTorch versions.  Every
verdict is integer and must be bit-identical to the reference: status,
cycles, violated counts and reason strings.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.dse import solve_block_status as ref_solve_block_status
from repro.core.incremental import compile_graph as ref_compile_graph
from repro.corpus import generate
import repro.designs.dynamic as ref_dynamic
import repro.designs.paper as ref_paper
import repro.designs.typea as ref_typea
from repro.designs.paper import fig4_ex4a as ref_fig4_ex4a
from repro.designs.paper import fig4_ex5 as ref_fig4_ex5
import repro_torch.core as T
import repro_torch.core.dse as tdse
from repro_torch.core import Emit, Program, Read, Write
from repro_torch.core.incremental import (GRAPH_FIELDS,
                                          compiled_graph_from_arrays)
import repro_torch.designs.dynamic as port_dynamic
import repro_torch.designs.paper as port_paper
import repro_torch.designs.typea as port_typea
from repro_torch.designs.paper import fig4_ex4a, fig4_ex5
from repro_torch.designs.typea import producer_consumer

DEVICE_LANES = ("cuda", "cuda_dense")
# the dense lane's plain version is O(K n^2) per sweep: on the CPU it is
# held on graphs up to this many nodes (the sparse lane on all of them)
DENSE_MAX_NODES = 600


def _assert_same(ref, port, what):
    assert (ref.status == port.status).all(), (what, ref.status, port.status)
    assert (ref.cycles == port.cycles).all(), (what, ref.cycles, port.cycles)
    assert (ref.violated == port.violated).all(), what
    assert ref.reasons == port.reasons, what
    assert ref.n_unique == port.n_unique, what


def _lanes(result):
    n = result.graph.graph.n_nodes
    return [b for b in DEVICE_LANES
            if b != "cuda_dense" or n <= DENSE_MAX_NODES]


def _design(modules, name):
    return next(getattr(m, name) for m in modules if hasattr(m, name))


def _both(name, kw):
    ref = R.simulate(_design((ref_typea, ref_paper, ref_dynamic), name)(**kw),
                     trace="never")
    port = T.simulate(_design((port_typea, port_paper, port_dynamic),
                               name)(**kw))
    assert ref.cycles == port.cycles and ref.outputs == port.outputs
    return ref, port


# (design, design kwargs): the golden designs' instances plus the
# iteration-heavy Type A designs, each on seeded depth rows
CASES = [
    ("fig4_ex2", dict(n=96)), ("fig4_ex3", dict(n=96)),
    ("fig4_ex4a", dict(n=96)), ("fig4_ex4a_d", dict(n=96)),
    ("fig4_ex4b", dict(n=96)), ("fig4_ex4b_d", dict(n=96)),
    ("fig4_ex5", dict(n=96)), ("fig2_timer", dict(n=96)),
    ("branch", dict(prog_len=128)),
    ("multicore", dict(cores=4, prog_len=32)),
    ("watchdog_pipe", dict(items=96, stages=2, depth=4, poll_gap=16)),
    ("fig2_poll_burst", dict(items=96, stages=2, depth=4)),
    ("multisite_poll", dict(items=96, depth=16)),
    ("nb_success_stream", dict(items=96, depth=16)),
    ("producer_consumer", dict(n=64)), ("fir_filter", dict(n=96, taps=4)),
    ("parallel_loops", dict(n=64)), ("merge_sort_staged", dict(log_n=4)),
    ("skynet_like", dict(items=96, depth=8)),
    ("high_latency_pipe", dict(items=24, stages=3, ii=16)),
    ("matmul_stream", dict(m=4, k=4, n=4)),
    ("merge_sort_staged", dict(log_n=5)),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_device_lanes_match_reference_numpy(name, kw):
    ref, port = _both(name, kw)
    F = len(ref.depths)
    rng = np.random.default_rng(0)
    D = np.concatenate([
        [np.asarray(ref.depths) + 1, np.asarray(ref.depths), np.ones(F)],
        rng.integers(1, 9, size=(13, F)),
        rng.integers(1, 9, size=(2, F))[[0, 0]],      # a duplicate row
    ]).astype(np.int64)
    want = R.resimulate_batch(ref, D, backend="numpy", fallback=False)
    for lane in _lanes(port):
        got = T.resimulate_batch(port, D, backend=lane, device="cpu",
                                 fallback=False)
        _assert_same(want, got, (name, lane))
    host = T.resimulate_batch(port, D, backend="numpy", fallback=False)
    _assert_same(want, host, (name, "numpy"))


def test_deadlocked_base_run_agrees():
    """The golden ``deadlock`` design deadlocks in its base run; the lanes
    must still agree with the reference on whatever it recorded."""
    ref, port = _both("deadlock", dict(n=16))
    D = np.array([[1, 1], [2, 2], [8, 8]], dtype=np.int64)[:, :len(ref.depths)]
    want = R.resimulate_batch(ref, D, backend="numpy", fallback=False)
    for lane in _lanes(port):
        _assert_same(want, T.resimulate_batch(port, D, backend=lane,
                                              device="cpu", fallback=False),
                     lane)


@pytest.mark.parametrize("lane", DEVICE_LANES)
def test_typec_fallback_outcomes_match(lane):
    """Type B/C designs with constraint flips, fallback on: the fallback
    re-simulation's cycles and outputs must match the reference too."""
    for ref_b, port_b, D in (
            (lambda: ref_fig4_ex5(n=96), lambda: fig4_ex5(n=96),
             np.array([(2, 100), (100, 2), (2, 2), (1, 1), (64, 64)])),
            (lambda: ref_fig4_ex4a(n=96), lambda: fig4_ex4a(n=96),
             np.array([[1], [2], [3], [8], [96]]))):
        ref = R.resimulate_batch(R.simulate(ref_b()), D, backend="numpy")
        port = T.resimulate_batch(T.simulate(port_b()), D, backend=lane,
                                  device="cpu")
        _assert_same(ref, port, lane)
        for a, b in zip(ref.results, port.results):
            assert a.outputs == b.outputs and a.deadlock == b.deadlock


def _leftover(P, Em, Rd, Wr):
    prog = P("leftover", declared_type="A")
    d = prog.fifo("d", 8)

    @prog.module("p")
    def p():
        for i in range(8):
            yield Wr(d, i)

    @prog.module("c")
    def c():
        tot = 0
        for _ in range(4):
            tot += (yield Rd(d))
        yield Em("sum", tot)

    return prog


def _burst_pingpong(P, Em, Rd, Wr, n=8, depth=8):
    prog = P("burst_pingpong", declared_type="A")
    cmd = prog.fifo("cmd", depth)
    resp = prog.fifo("resp", depth)

    @prog.module("ctrl")
    def ctrl():
        for i in range(n):
            yield Wr(cmd, i)
        tot = 0
        for _ in range(n):
            tot += (yield Rd(resp))
        yield Em("sum", tot)

    @prog.module("proc")
    def proc():
        for _ in range(n):
            v = yield Rd(cmd)
            yield Wr(resp, 2 * v)

    return prog


REF_DSL = (R.Program, R.Emit, R.Read, R.Write)
PORT_DSL = (Program, Emit, Read, Write)


@pytest.mark.parametrize("lane", DEVICE_LANES + ("numpy", "reference"))
@pytest.mark.parametrize("make,D", [
    (_leftover, np.array([[8], [4], [3], [1]])),
    (_burst_pingpong, np.array([(1, 1), (2, 2), (1, 8), (8, 1), (4, 4),
                                (8, 8)])),
], ids=["new_deadlock", "war_cycle"])
def test_deadlock_and_war_cycle_verdicts(make, D, lane):
    """``tests/test_dse.py``'s starved-write DEADLOCK and inverted-order
    WAR CYCLE cases, fallback on, every lane."""
    ref = R.resimulate_batch(R.simulate(make(*REF_DSL)), D,
                             backend="numpy")
    port = T.resimulate_batch(T.simulate(make(*PORT_DSL)), D,
                              backend=lane, device="cpu")
    _assert_same(ref, port, lane)
    for a, b in zip(ref.results, port.results):
        assert a.cycles == b.cycles and a.deadlock == b.deadlock
        assert a.outputs == b.outputs
    if make is _burst_pingpong:
        assert (port.status[:2] == tdse.CYCLE).all()
        assert port.results[0].deadlock


def _small_base():
    return T.simulate(producer_consumer(n=24, depth=3))


def test_dense_lane_chunks_by_capacity(monkeypatch):
    """A batch larger than the dense capacity is slab-chunked (one config
    per slab here), not rejected."""
    base = _small_base()
    n = base.graph.graph.n_nodes
    D = np.array([[1], [2], [3], [4], [6], [8]])
    monkeypatch.setattr(tdse, "_DENSE_CAP", n * n)
    want = T.resimulate_batch(base, D, backend="numpy")
    got = T.resimulate_batch(base, D, backend="cuda_dense", device="cpu")
    _assert_same(want, got, "chunked")


def test_dense_lane_single_config_capacity_error(monkeypatch):
    base = _small_base()
    n = base.graph.graph.n_nodes
    monkeypatch.setattr(tdse, "_DENSE_CAP", n * n - 1)
    with pytest.raises(ValueError, match="numpy"):
        T.resimulate_batch(base, np.array([[4]]), backend="cuda_dense",
                           device="cpu")


def test_device_lanes_refuse_int32_overflow():
    """Both int32 lanes refuse (not silently wrap) a graph whose
    path-length bound reaches 2^28."""
    base = _small_base()
    ba = tdse._batch_arrays(T.compile_graph(base.graph))
    old = ba.bound
    try:
        ba.bound = 1 << 28
        for lane in DEVICE_LANES:
            with pytest.raises(ValueError, match="numpy"):
                T.resimulate_batch(base, np.array([[4]]), backend=lane,
                                   device="cpu", fallback=False)
    finally:
        ba.bound = old


@pytest.mark.parametrize("lane", DEVICE_LANES)
def test_small_blocks_give_the_same_verdicts(lane):
    ref, port = _both("merge_sort_staged", dict(log_n=4))
    D = np.random.default_rng(3).integers(1, 9, size=(10, len(ref.depths)))
    want = R.resimulate_batch(ref, D, backend="numpy", fallback=False)
    got = T.resimulate_batch(port, D, backend=lane, device="cpu", block=3,
                             fallback=False)
    _assert_same(want, got, lane)


def test_default_device_raises_without_a_card(monkeypatch):
    """The device lanes default to ``device="cuda"`` and never carry on on
    the CPU by themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = _small_base()
    for lane in DEVICE_LANES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.resimulate_batch(base, np.array([[4]]), backend=lane)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.solve_block_status(T.compile_graph(base.graph),
                                 np.array([[4]]), backend=lane)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.resimulate_batch(base, np.array([[4]]))      # default lane
    # the host lanes run on the host whatever the device
    out = T.resimulate_batch(base, np.array([[4]]), backend="numpy")
    assert out.ok.all()


def test_unknown_backend_and_bad_shapes_raise():
    base = _small_base()
    with pytest.raises(ValueError, match="backend"):
        T.resimulate_batch(base, np.array([[4]]), backend="jax",
                           device="cpu")
    with pytest.raises(ValueError):
        T.resimulate_batch(base, np.ones((3, 5), dtype=int), device="cpu")


def test_reused_shells_do_not_alias_mutable_state():
    base = T.simulate(producer_consumer(n=32, depth=4))
    out = T.resimulate_batch(base, np.array([[4], [8], [16]]), device="cpu")
    assert out.ok.all()
    r0, r1 = out.results[0], out.results[1]
    assert r0.stats is not base.stats and r0.stats is not r1.stats
    r0.stats.queries = -123
    r0.constraints.append("sentinel")
    assert r1.stats.queries != -123 and base.stats.queries != -123
    assert "sentinel" not in r1.constraints
    assert "sentinel" not in base.constraints


# ---------------------------------------------------------------------------
# reference-built corpus graphs, carried across as plain arrays
# ---------------------------------------------------------------------------
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "corpus_seeds.json")) as _f:
    CORPUS = [(r["seed"], r["scale"]) for r in json.load(_f)]


def _carry(ref_graph):
    fields = {k: getattr(ref_graph, k) for k in GRAPH_FIELDS}
    return compiled_graph_from_arrays(fields)


@pytest.mark.parametrize("seed,scale", CORPUS)
def test_corpus_graphs_solve_like_the_reference(seed, scale):
    """``solve_block_status`` on a reference-built corpus graph (built by
    the reference's simulator, taken across with
    ``compiled_graph_from_arrays``) against the reference's numpy lane."""
    case = generate(seed, scale=scale)
    base = R.simulate(case.builder())
    ref_g = ref_compile_graph(base.graph)
    port_g = _carry(ref_g)
    F = len(base.depths)
    rng = np.random.default_rng(seed)
    D = np.concatenate([[np.asarray(base.depths)],
                        rng.integers(1, 9, size=(11, F))]).astype(np.int64)
    want = ref_solve_block_status(ref_g, D, backend="numpy")
    lanes = ["numpy", "cuda"] + (["cuda_dense"]
                                 if port_g.n <= DENSE_MAX_NODES else [])
    for lane in lanes:
        got = T.solve_block_status(port_g, D, backend=lane, device="cpu")
        for w, g, what in zip(want[:3], got[:3],
                              ("status", "cycles", "violated")):
            assert np.array_equal(w, g), (seed, scale, lane, what, w, g)


def test_compiled_graph_from_arrays_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        compiled_graph_from_arrays({"n": 0})
