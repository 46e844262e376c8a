"""PyTorch port, seventh slice: trace-compiled replay
(``repro_torch.core.trace``).

Two oracles.  The reference's own replay (``repro.core.trace``): the same
seeded design goes through both packages' ``record_trace``,
``ModuleTrace.periodize``, ``compile_trace``, ``_solve_times``,
``to_compiled_graph`` and ``simulate_traced``, and every array, count and
table must be equal (both packages number nodes chain-major, so node times
compare index for index).  And the port's own generator engine, on the
cases of the reference's ``tests/test_trace.py``: the replay's results
equal the generator engine's, and the designs the replay cannot run fall
back to it with the exact report.  Sizes are the reference test's small
ones; exactness does not depend on size.
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.program as rdsl
import repro.core.trace as rtrace
import repro.designs.dynamic as rdynamic
import repro.designs.paper as rpaper
import repro.designs.typea as rtypea
import repro_torch.core as T
import repro_torch.core.program as tdsl
import repro_torch.core.trace as ttrace
import repro_torch.designs.dynamic as tdynamic
import repro_torch.designs.paper as tpaper
import repro_torch.designs.typea as ttypea
from repro_torch.core import (TraceUnsupported, compile_graph, compile_trace,
                              record_trace, resimulate, resimulate_batch,
                              simulate, simulate_traced)


def _typea_small(typea):
    D = typea.TYPEA_DESIGNS
    return {
        "producer_consumer": lambda: D["producer_consumer"](n=48),
        "fir_filter": lambda: D["fir_filter"](n=64),
        "window_conv": lambda: D["window_conv"](rows=12, cols=12),
        "matmul_stream": lambda: D["matmul_stream"](m=6, k=6, n=6),
        "sqrt_pipe": lambda: D["sqrt_pipe"](n=48),
        "parallel_loops": lambda: D["parallel_loops"](n=48),
        "nested_loops": lambda: D["nested_loops"](outer=8, inner=8),
        "accumulators": lambda: D["accumulators"](n=48),
        "vector_add_stream": lambda: D["vector_add_stream"](n=96),
        "merge_sort_staged": lambda: D["merge_sort_staged"](log_n=5),
        "huffman_pipe": lambda: D["huffman_pipe"](n=64),
        "flowgnn_like": lambda: D["flowgnn_like"](n_nodes=32),
        "skynet_like": lambda: D["skynet_like"](items=48, depth=6),
        "latency_pipe": lambda: D["latency_pipe"](items=24, ii=16),
    }


def _paper_small(paper):
    P = paper.PAPER_DESIGNS
    return {
        "fig4_ex2": lambda: P["fig4_ex2"](n=64),
        "fig4_ex3": lambda: P["fig4_ex3"](n=64),
        "fig4_ex4a": lambda: P["fig4_ex4a"](n=64),
        "fig4_ex4a_d": lambda: P["fig4_ex4a_d"](n=64),
        "fig4_ex4b": lambda: P["fig4_ex4b"](n=64),
        "fig4_ex4b_d": lambda: P["fig4_ex4b_d"](n=64),
        "fig4_ex5": lambda: P["fig4_ex5"](n=64),
        "fig2_timer": lambda: P["fig2_timer"](n=64),
        "deadlock": lambda: P["deadlock"](n=8),
        "branch": lambda: P["branch"](prog_len=128),
        "multicore": lambda: P["multicore"](cores=4, prog_len=32),
    }


TYPEA_SMALL = _typea_small(ttypea)
PAPER_SMALL = _paper_small(tpaper)
# (port design, reference design) pairs that compile in both packages
PAIRS = {name: (TYPEA_SMALL[name], ref)
         for name, ref in _typea_small(rtypea).items()}
PAIRS["fig4_ex3"] = (PAPER_SMALL["fig4_ex3"],
                     _paper_small(rpaper)["fig4_ex3"])
PAIRS["skynet_like_default"] = (ttypea.skynet_like, rtypea.skynet_like)
PAIRED = sorted(PAIRS)


# ------------------------------------------------------- hand-built designs
def _pc(d, depth, delay, n=16):
    prog = d.Program("pc", declared_type="A")
    data = prog.fifo("data", depth)

    @prog.module("producer")
    def producer():
        for i in range(1, n + 1):
            yield d.Write(data, i)

    @prog.module("consumer")
    def consumer():
        total = 0
        for _ in range(n):
            total += (yield d.Read(data))
            if delay:
                yield d.Delay(delay)
        yield d.Emit("sum", total)

    return prog


def _leftover(d, depth):
    prog = d.Program("leftover", declared_type="A")
    f = prog.fifo("d", depth)

    @prog.module("p")
    def p():
        for i in range(8):
            yield d.Write(f, i)

    @prog.module("c")
    def c():
        tot = 0
        for _ in range(4):
            tot += (yield d.Read(f))
        yield d.Emit("sum", tot)

    return prog


def _burst(d, depth):
    prog = d.Program("burst", declared_type="A")
    cmd = prog.fifo("cmd", depth)
    resp = prog.fifo("resp", depth)

    @prog.module("ctrl")
    def ctrl():
        for i in range(8):
            yield d.Write(cmd, i)
        tot = 0
        for _ in range(8):
            tot += (yield d.Read(resp))
        yield d.Emit("sum", tot)

    @prog.module("proc")
    def proc():
        for _ in range(8):
            v = yield d.Read(cmd)
            yield d.Write(resp, 2 * v)

    return prog


def _dead_probes(d):
    prog = d.Program("deadprobe", declared_type="A")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        for i in range(4):
            yield d.Full(f, used=False)
            yield d.Write(f, i)

    @prog.module("c")
    def c():
        total = 0
        for _ in range(4):
            total += (yield d.Read(f))
        yield d.Emit("total", total)

    return prog


def _poll(d):
    prog = d.Program("poll", declared_type="B")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        yield d.Delay(10)
        yield d.Write(f, 42)

    @prog.module("c")
    def c():
        polls = 0
        while True:
            ok, _ = yield d.ReadNB(f)
            polls += 1
            if ok:
                break
        yield d.Emit("polls", polls)

    return prog


def _two_readers(d):
    prog = d.Program("mpmc", declared_type="A")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        for i in range(4):
            yield d.Write(f, i)

    @prog.module("c1")
    def c1():
        yield d.Read(f)

    @prog.module("c2")
    def c2():
        yield d.Read(f)

    return prog


def _drain_while_parked(d):
    prog = d.Program("mpmc2", declared_type="A")
    f = prog.fifo("f", 2)
    g2 = prog.fifo("g2", 2)

    @prog.module("ra")
    def ra():
        yield d.Read(f)                    # parks on empty f

    @prog.module("w")
    def w():
        yield d.Write(g2, 1)
        yield d.Write(f, 2)

    @prog.module("rb")
    def rb():
        yield d.Read(g2)
        yield d.Read(f)                    # drains f before ra wakes

    return prog


def _livelock(d):
    prog = d.Program("spin", declared_type="A")

    @prog.module("spin")
    def spin():
        while True:
            yield d.Delay(1)

    return prog


# ------------------------------------------------------------- comparators
def _same_results(r_gen, r_tr, name=""):
    assert r_tr.outputs == r_gen.outputs, name
    assert r_tr.cycles == r_gen.cycles, name
    assert r_tr.deadlock == r_gen.deadlock, name
    assert r_tr.deadlock_cycle == r_gen.deadlock_cycle, name
    assert r_tr.depths == r_gen.depths, name


def _same_fifo_tables(fifos_a, fifos_b, exact):
    """Equal FIFO tables; ``exact`` compares node ids and times index for
    index (same numbering), else the sorted times (another numbering)."""
    assert len(fifos_a) == len(fifos_b)
    for t1, t2 in zip(fifos_a, fifos_b):
        assert (t1.fid, t1.name, t1.depth) == (t2.fid, t2.name, t2.depth)
        assert (t1.n_writes, t1.n_reads) == (t2.n_writes, t2.n_reads)
        if exact:
            for f in ("writes", "reads", "write_times", "read_times"):
                np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f))
        else:
            for f in ("write_times", "read_times"):
                np.testing.assert_array_equal(np.sort(getattr(t1, f)),
                                              np.sort(getattr(t2, f)))
        assert list(t1.values) == list(t2.values)      # leftover payloads


def _same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_module_traces(mine, theirs):
    assert len(mine) == len(theirs)
    for m, r in zip(mine, theirs):
        assert (m.mid, m.name, m.end_gap, m.lead, m.reps, m.no_period,
                m.n_ops, m.n_stored) == (r.mid, r.name, r.end_gap, r.lead,
                                         r.reps, r.no_period, r.n_ops,
                                         r.n_stored), m.name
        for f in ("kind", "fifo", "gap"):
            _same_arrays(getattr(m, f), getattr(r, f), f"{m.name}.{f}")


def _compiled(pair):
    mine_b, ref_b = pair
    mp, rp = mine_b(), ref_b()
    mc = compile_trace(record_trace(mp), len(mp.fifos))
    rc = rtrace.compile_trace(rtrace.record_trace(rp), len(rp.fifos))
    return mp, rp, mc, rc


# ------------------------------------------- replay against the reference's
@pytest.mark.parametrize("keep_values", [False, True])
@pytest.mark.parametrize("name", PAIRED)
def test_record_trace_matches_reference(name, keep_values):
    mine_b, ref_b = PAIRS[name]
    mine = record_trace(mine_b(), keep_values=keep_values)
    theirs = rtrace.record_trace(ref_b(), keep_values=keep_values)
    assert mine.program == theirs.program
    _same_module_traces(mine.modules, theirs.modules)
    assert mine.outputs == theirs.outputs
    assert mine.leftovers == theirs.leftovers
    assert (mine.skipped_probes, mine.steps, mine.activations) == \
        (theirs.skipped_probes, theirs.steps, theirs.activations)
    assert mine.values == theirs.values
    assert mine.module_emits == theirs.module_emits
    assert mine.module_skips == theirs.module_skips
    assert (mine.values is None) == (not keep_values)


@pytest.mark.parametrize("name", PAIRED)
def test_periodize_matches_reference(name):
    """Same periods, leads and stored rows as the reference's periodizer,
    ``skynet_like()`` at its defaults included; expansion is lossless."""
    mine_b, ref_b = PAIRS[name]
    mine = record_trace(mine_b())
    theirs = rtrace.record_trace(ref_b())
    full = [m.expand() for m in mine.modules]
    assert mine.periodize() is mine
    theirs.periodize()
    _same_module_traces(mine.modules, theirs.modules)
    assert (mine.n_ops, mine.n_stored) == (theirs.n_ops, theirs.n_stored)
    for m, arrays in zip(mine.modules, full):
        for a, b in zip(m.expand(), arrays):
            np.testing.assert_array_equal(a, b)
    assert mine.periodize().n_stored == mine.n_stored      # idempotent


@pytest.mark.parametrize("name", PAIRED)
def test_compile_trace_matches_reference(name):
    """Every field of ``CompiledTrace``, and the WAR edges under three depth
    vectors (the design's, all ones, doubled): equal arrays, or both raise
    the structural deadlock."""
    mp, rp, mc, rc = _compiled(PAIRS[name])
    assert (mc.n, mc.n_modules, mc.slices) == (rc.n, rc.n_modules, rc.slices)
    for f in ("seq_w", "base", "node_kind", "node_fifo", "node_seq",
              "fifo_wmod", "fifo_rmod", "raw_dst", "raw_src"):
        _same_arrays(getattr(mc, f), getattr(rc, f), f)
    for f in ("fifo_w_nodes", "fifo_r_nodes"):
        assert len(getattr(mc, f)) == len(getattr(rc, f))
        for a, b in zip(getattr(mc, f), getattr(rc, f)):
            _same_arrays(a, b, f)
    d0 = np.asarray(mp.depths())
    for depths in (d0, np.ones_like(d0), 2 * d0):
        try:
            want = rc.war_edges(depths)
        except rtrace.TraceUnsupported:
            with pytest.raises(TraceUnsupported, match="structural deadlock"):
                mc.war_edges(depths)
            continue
        got = mc.war_edges(depths)
        _same_arrays(got[0], want[0], "war_dst")
        _same_arrays(got[1], want[1], "war_src")


@pytest.mark.parametrize("name", PAIRED)
def test_solve_times_matches_reference(name):
    """Times and sweep counts, cold and warm (from the solution itself with
    one chain dirty, and from the deeper-FIFO solution with every chain
    dirty), with and without a prebuilt bucket table."""
    mp, rp, mc, rc = _compiled(PAIRS[name])
    d0 = np.asarray(mp.depths())
    wd, ws = mc.war_edges(d0)
    rwd, rws = rc.war_edges(d0)
    t, sweeps = ttrace._solve_times(mc, wd, ws)
    rt, rsweeps = rtrace._solve_times(rc, rwd, rws)
    _same_arrays(t, rt, "times")
    assert sweeps == rsweeps
    starts = np.asarray([lo for lo, _ in mc.slices], np.int64)
    buckets = ttrace._cross_buckets(mc, wd, ws, starts)
    rbuckets = rtrace._cross_buckets(rc, rwd, rws, starts)
    assert sorted(buckets) == sorted(rbuckets)
    for k in buckets:
        assert len(buckets[k]) == len(rbuckets[k])
        for (dc, s, d), (rdc, rs, rd) in zip(buckets[k], rbuckets[k]):
            assert dc == rdc
            _same_arrays(s, rs, "bucket src")
            _same_arrays(d, rd, "bucket dst")
    assert ttrace._solve_times(mc, wd, ws, buckets=buckets)[1] == sweeps
    deep_w = mc.war_edges(2 * d0)
    t_deep, _ = ttrace._solve_times(mc, *deep_w)
    everything = list(range(mc.n_modules))
    for warm in ((t, [0]), (t_deep, everything)):
        got = ttrace._solve_times(mc, wd, ws, warm=warm)
        want = rtrace._solve_times(rc, rwd, rws, warm=warm)
        _same_arrays(got[0], want[0], "warm times")
        assert got[1] == want[1]
        _same_arrays(got[0], t, "warm vs cold")


@pytest.mark.parametrize("name", PAIRED)
def test_to_compiled_graph_matches_reference(name):
    mp, rp, mc, rc = _compiled(PAIRS[name])
    mine, theirs = ttrace.to_compiled_graph(mc), rtrace.to_compiled_graph(rc)
    assert mine.n == theirs.n
    for f in ("raw_dst", "raw_src", "raw_w", "base", "seq_w", "c_kind",
              "c_fifo", "c_seq", "c_src", "c_out"):
        _same_arrays(getattr(mine, f), getattr(theirs, f), f)
    assert len(mine.chains) == len(theirs.chains)
    for a, b in zip(mine.chains, theirs.chains):
        _same_arrays(a, b, "chain")
    assert len(mine.fifos) == len(theirs.fifos)
    for (w1, r1, b1), (w2, r2, b2) in zip(mine.fifos, theirs.fifos):
        _same_arrays(w1, w2, "writes")
        _same_arrays(r1, r2, "reads")
        _same_arrays(b1, b2, "blocking")


@pytest.mark.parametrize("name", PAIRED)
def test_simulate_traced_matches_reference(name):
    """The whole front door: result, stats, graph, FIFO tables, endpoint
    maps, the installed compiled graph and the periodized trace."""
    mine_b, ref_b = PAIRS[name]
    a = simulate_traced(mine_b())
    b = rtrace.simulate_traced(ref_b())
    assert a.engine == b.engine == "omnisim-trace"
    _same_results(b, a, name)
    assert a.constraints == [] and b.constraints == []
    for f in ("nodes", "edges", "queries", "queries_forced_false",
              "queries_periodized", "quiescence_rounds", "resumes",
              "skipped_probes"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    ga, gb = a.graph.graph, b.graph.graph
    assert (ga.n_nodes, ga.n_edges) == (gb.n_nodes, gb.n_edges)
    _same_arrays(ga.times(), gb.times(), "times")
    for x, y in zip(ga.to_csr(), gb.to_csr()):
        _same_arrays(x, y, "csr")
    _same_fifo_tables(a.graph.fifos, b.graph.fifos, exact=True)
    assert a.graph._writer_of == b.graph._writer_of
    assert a.graph._reader_of == b.graph._reader_of
    assert a.graph.outputs == b.graph.outputs
    assert (a.graph._trace.n_ops, a.graph._trace.n_stored) == \
        (b.graph._trace.n_ops, b.graph._trace.n_stored)
    assert compile_graph(a.graph) is a.graph._incr_cache
    if ga.n_nodes <= 2000:
        for na, nb in zip(ga.nodes, gb.nodes):
            assert (na.idx, na.module, na.kind.value, na.time, na.fifo,
                    na.seq, na.preds) == (nb.idx, nb.module, nb.kind.value,
                                          nb.time, nb.fifo, nb.seq, nb.preds)


_ALL_AUTO = {**{f"typea/{k}": (v, _typea_small(rtypea)[k])
                for k, v in TYPEA_SMALL.items()},
             **{f"paper/{k}": (v, _paper_small(rpaper)[k])
                for k, v in PAPER_SMALL.items()},
             **{f"dynamic/{k}": (lambda k=k: tdynamic.DYNAMIC_DESIGNS[k](),
                                 lambda k=k: rdynamic.DYNAMIC_DESIGNS[k]())
                for k in sorted(tdynamic.DYNAMIC_DESIGNS)}}


@pytest.mark.parametrize("name", sorted(_ALL_AUTO))
def test_auto_path_matches_reference(name):
    """``simulate(trace="auto")`` takes compiled replay exactly where the
    reference does; where the reference takes its hybrid replay the port
    takes the generator engine, with the same results."""
    mine_b, ref_b = _ALL_AUTO[name]
    a, b = simulate(mine_b()), R.simulate(ref_b())
    assert a.engine == {"omnisim-hybrid": "omnisim"}.get(b.engine, b.engine)
    _same_results(b, a, name)
    for f in ("nodes", "edges", "queries", "queries_forced_false",
              "skipped_probes"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    _same_fifo_tables(a.graph.fifos, b.graph.fifos,
                      exact=a.engine == b.engine)


# ----------------------------------- replay against the port's generator
@pytest.mark.parametrize("name", sorted(TYPEA_SMALL))
def test_typea_compiled_equals_generator(name):
    """Blocking-only designs take the compiled path and match the port's
    generator engine exactly: graph shape, times multiset, FIFO tables."""
    b = TYPEA_SMALL[name]
    r_gen = simulate(b(), trace="never")
    r_tr = simulate(b(), trace="auto")
    assert r_gen.engine == "omnisim" and r_tr.engine == "omnisim-trace"
    _same_results(r_gen, r_tr, name)
    g1, g2 = r_gen.graph.graph, r_tr.graph.graph
    assert (g1.n_nodes, g1.n_edges) == (g2.n_nodes, g2.n_edges)
    assert (r_gen.stats.nodes, r_gen.stats.edges) == \
        (r_tr.stats.nodes, r_tr.stats.edges)
    np.testing.assert_array_equal(np.sort(g1.times()), np.sort(g2.times()))
    _same_fifo_tables(r_gen.graph.fifos, r_tr.graph.fifos, exact=False)


@pytest.mark.parametrize("name", sorted(PAPER_SMALL))
def test_taxonomy_compiled_equals_generator(name):
    """Every taxonomy design: ``"auto"`` equals the generator engine,
    whether it compiled or fell back; the cyclic blocking-only fig4_ex3
    must compile."""
    b = PAPER_SMALL[name]
    r_gen = simulate(b(), trace="never")
    r_tr = simulate(b(), trace="auto")
    _same_results(r_gen, r_tr, name)
    if name == "fig4_ex3":
        assert r_tr.engine == "omnisim-trace"


@pytest.mark.parametrize("depth", [1, 2, 3, 7, 100])
@pytest.mark.parametrize("delay", [0, 1, 3])
def test_depth_delay_sweep_compiled(depth, delay):
    r = simulate(_pc(tdsl, depth, delay), trace="always")
    assert r.engine == "omnisim-trace"
    _same_results(simulate(_pc(tdsl, depth, delay), trace="never"), r)
    _same_results(R.simulate(_pc(rdsl, depth, delay), trace="always"), r)


def test_dead_probes_compile():
    """Unused Empty/Full probes are statically dead (paper Sec. 7.3.2):
    they cost one cycle and do not force a generator fallback."""
    r = simulate(_dead_probes(tdsl), trace="always")
    assert r.stats.skipped_probes == 4
    _same_results(simulate(_dead_probes(tdsl), trace="never"), r)
    assert record_trace(_dead_probes(tdsl), keep_values=True).module_skips \
        == [4, 0]


@pytest.mark.parametrize("lane", ["numpy", "cuda", "cuda_dense"])
def test_batch_from_trace_result_matches_generator_base(lane):
    """``resimulate_batch`` on a trace-compiled base agrees verdict for
    verdict with a generator-path base, on the host lane and on the device
    lanes' plain versions (``device="cpu"``)."""
    build = lambda: ttypea.skynet_like(items=48, depth=6)
    base_tr = simulate(build(), trace="always")
    base_gen = simulate(build(), trace="never")
    assert base_tr.graph._incr_cache is not None
    D = np.random.default_rng(11).integers(1, 13,
                                           size=(16, len(base_tr.depths)))
    kw = {} if lane == "numpy" else {"device": "cpu"}
    out_tr = resimulate_batch(base_tr, D, backend=lane, **kw)
    out_gen = resimulate_batch(base_gen, D, backend=lane, **kw)
    for f in ("ok", "cycles", "status", "violated"):
        np.testing.assert_array_equal(getattr(out_tr, f), getattr(out_gen, f))
    assert out_tr.reasons == out_gen.reasons


def test_resimulate_from_trace_result_matches_generator():
    build = lambda: ttypea.skynet_like(items=48, depth=6)
    base_tr = simulate(build(), trace="always")
    D = np.random.default_rng(11).integers(1, 13,
                                           size=(4, len(base_tr.depths)))
    for row in D:
        dv = tuple(int(x) for x in row)
        inc = resimulate(base_tr, dv)
        full = simulate(build(), depths=dv, trace="never")
        assert inc.result.cycles == full.cycles
        assert inc.result.outputs == full.outputs


def test_trace_graph_csr_and_nodes():
    """The trace graph keeps the SimGraph read contract: CSR longest path
    reproduces the times, and node materialization feeds ``classify``."""
    r = simulate(ttypea.skynet_like(items=24, depth=4))
    assert r.engine == "omnisim-trace"
    g = r.graph.graph
    np.testing.assert_array_equal(T.longest_path_numpy(*g.to_csr()),
                                  g.times())
    c = T.classify(ttypea.skynet_like(items=24, depth=4), r)
    assert c.dtype == "A" and not c.has_nonblocking


def test_record_trace_step_budget():
    with pytest.raises(RuntimeError, match="step budget"):
        record_trace(_livelock(tdsl), max_steps=1000)
    with pytest.raises(RuntimeError, match="step budget"):
        rtrace.record_trace(_livelock(rdsl), max_steps=1000)


# ----------------------------------------------------------------- fallbacks
def test_deadlock_falls_back_with_exact_stall_cycle():
    """Cyclic blocking wait: recording detects the untimed-KPN deadlock and
    the generator engine reports the exact stall cycle and blocked set."""
    b = PAPER_SMALL["deadlock"]
    with pytest.raises(TraceUnsupported, match="untimed KPN deadlock") as e:
        simulate_traced(b())
    assert not e.value.dynamic
    with pytest.raises(TraceUnsupported):
        simulate(b(), trace="always")
    r = simulate(b(), trace="auto")
    assert r.deadlock and r.engine == "omnisim"
    assert set(r.outputs["__deadlock__"]) == {"task_a", "task_b"}
    _same_results(simulate(b(), trace="never"), r)


def test_depth_induced_deadlock_falls_back():
    """Too small a FIFO: the trace compiles, but WAR generation finds the
    missing target read and ``"auto"`` reproduces the generator report."""
    assert simulate(_leftover(tdsl, 8)).engine == "omnisim-trace"
    with pytest.raises(TraceUnsupported, match="structural deadlock"):
        simulate_traced(_leftover(tdsl, 3))
    with pytest.raises(TraceUnsupported):
        simulate(_leftover(tdsl, 3), trace="always")
    r = simulate(_leftover(tdsl, 3), trace="auto")
    assert r.deadlock and r.engine == "omnisim"
    _same_results(simulate(_leftover(tdsl, 3), trace="never"), r)
    _same_results(R.simulate(_leftover(rdsl, 3)), r)


def test_war_cycle_deadlock_falls_back():
    """Burst ping-pong at depth 1: the regenerated WAR edges form a cycle,
    so the replay refuses and the generator engine finds the deadlock."""
    assert simulate(_burst(tdsl, 8)).engine == "omnisim-trace"
    with pytest.raises(TraceUnsupported, match="WAR edges form a cycle"):
        simulate_traced(_burst(tdsl, 1))
    with pytest.raises(TraceUnsupported):
        simulate(_burst(tdsl, 1), trace="always")
    r = simulate(_burst(tdsl, 1), trace="auto")
    assert r.deadlock and r.engine == "omnisim"
    _same_results(simulate(_burst(tdsl, 1), trace="never"), r)
    _same_results(R.simulate(_burst(rdsl, 1)), r)


@pytest.mark.parametrize("build", [_two_readers, _drain_while_parked])
def test_spsc_violation_falls_back_to_engine_assertion(build):
    """Two readers on one FIFO: the recorder defers, and the generator
    engine's endpoint check raises its AssertionError."""
    with pytest.raises(TraceUnsupported, match="SPSC"):
        simulate_traced(build(tdsl))
    with pytest.raises(TraceUnsupported, match="SPSC"):
        simulate(build(tdsl), trace="always")
    with pytest.raises(AssertionError, match="SPSC"):
        simulate(build(tdsl), trace="auto")


def test_spsc_violation_in_compile_trace():
    """Two writer modules whose writes the recorder accepts: the compile
    step's endpoint check refuses them."""
    def build(d):
        prog = d.Program("two_writers", declared_type="A")
        f = prog.fifo("f", 4)

        @prog.module("w1")
        def w1():
            yield d.Write(f, 1)

        @prog.module("w2")
        def w2():
            yield d.Write(f, 2)

        @prog.module("r")
        def r():
            yield d.Read(f)
            yield d.Read(f)

        return prog

    rec = record_trace(build(tdsl))
    with pytest.raises(TraceUnsupported, match="SPSC"):
        compile_trace(rec, 1)
    with pytest.raises(rtrace.TraceUnsupported, match="SPSC"):
        rtrace.compile_trace(rtrace.record_trace(build(rdsl)), 1)
    with pytest.raises(AssertionError, match="SPSC"):
        simulate(build(tdsl), trace="auto")


def test_dynamic_design_takes_the_generator_engine():
    """An NB outcome steering control flow: the straight-line replay raises
    a dynamic ``TraceUnsupported``; ``"auto"`` gives the generator's result
    (the reference's hybrid result), ``"always"`` names queue 1 item 5."""
    with pytest.raises(TraceUnsupported) as e:
        simulate_traced(_poll(tdsl))
    assert e.value.dynamic
    r = simulate(_poll(tdsl), trace="auto")
    assert r.engine == "omnisim" and r.outputs == {"polls": 12}
    _same_results(simulate(_poll(tdsl), trace="never"), r)
    ref = R.simulate(_poll(rdsl), trace="always")
    assert ref.engine == "omnisim-hybrid"
    _same_results(ref, r)
    with pytest.raises(NotImplementedError, match="item 5"):
        simulate(_poll(tdsl), trace="always")


def test_shuffle_seed_uses_generator_path():
    r = simulate(ttypea.producer_consumer(n=16), shuffle_seed=3)
    assert r.engine == "omnisim"
    with pytest.raises(ValueError, match="shuffle_seed"):
        simulate(ttypea.producer_consumer(n=8), shuffle_seed=1,
                 trace="always")


def test_fifo_shell_tables_grow_from_empty():
    """A shell table (no capacity) allocates on its first append."""
    from repro_torch.core.fifo import FifoTable
    t = FifoTable._shell(0, "f", 2)
    assert t.n_writes == t.n_reads == 0 and len(t.writes) == 0
    for i in range(20):
        assert t.commit_write(i, 10 + i, i) == i + 1
    for i in range(20):
        assert t.commit_read(100 + i, 20 + i) == i
    np.testing.assert_array_equal(t.write_times, np.arange(10, 30))
    np.testing.assert_array_equal(t.reads, np.arange(100, 120))
