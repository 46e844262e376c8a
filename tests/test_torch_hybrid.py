"""PyTorch port, eighth slice: the hybrid segmented replay for NB/probe
designs (``repro_torch.core.trace``: ``HybridSim``, ``HybridCache``,
``simulate_hybrid``; ``simulate(hybrid_cache=, periodize=)``).

Every case of the reference's ``tests/test_hybrid.py`` is written once, as
a function of a package (``REF``: ``repro``; ``PORT``: ``repro_torch``),
runs on both from the same builders, and returns what it observed: each
result's outputs, cycles, deadlock, depths, every ``SimStats`` counter,
the constraint records, node times and FIFO tables, ``hybrid_info``
(``graph._hybrid``) and the ``HybridCache`` counters over the run
sequence.  The port's observation must equal the reference's.  Both
hybrids number nodes module by module, so their node times and
constraints compare index for index; against the generator engine (which
numbers nodes in creation order) times compare as multisets and FIFO
tables sorted, as in the reference's test.  ``HybridCache`` keys hash
each package's own bytecode and are never compared.

Then the golden records (``tests/golden/*.json``, the reference generator
engine's results) through the port's ``simulate_hybrid`` with
``periodize`` on and off, and the cases of
``tests/test_taxonomy_dynamic.py`` through the port's
``classify_dynamic`` with and without a passed cache.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.program as ref_dsl
import repro.core.trace as ref_trace
import repro.designs.dynamic as ref_dynamic
import repro.designs.paper as ref_paper
import repro.designs.typea as ref_typea
import repro_torch.core as port_core
import repro_torch.core.program as port_dsl
import repro_torch.core.trace as port_trace
import repro_torch.designs.dynamic as port_dynamic
import repro_torch.designs.paper as port_paper
import repro_torch.designs.typea as port_typea
from test_hybrid import _assert_bit_identical
from test_torch_engine import GOLDEN_DIR, _golden_designs, _normalize, _record

REF = SimpleNamespace(core=ref_core, trace=ref_trace, dsl=ref_dsl,
                      paper=ref_paper, dynamic=ref_dynamic, typea=ref_typea)
PORT = SimpleNamespace(core=port_core, trace=port_trace, dsl=port_dsl,
                       paper=port_paper, dynamic=port_dynamic,
                       typea=port_typea)


def _hybrid_small(pkg):
    """``_HYBRID_SMALL`` of the reference's test, from one package."""
    P = pkg.paper.PAPER_DESIGNS
    return {
        "fig4_ex2": lambda: P["fig4_ex2"](n=64),
        "fig4_ex4a": lambda: P["fig4_ex4a"](n=64),
        "fig4_ex4a_d": lambda: P["fig4_ex4a_d"](n=64),
        "fig4_ex4b": lambda: P["fig4_ex4b"](n=64),
        "fig4_ex4b_d": lambda: P["fig4_ex4b_d"](n=64),
        "fig4_ex5": lambda: P["fig4_ex5"](n=64),
        "fig2_timer": lambda: P["fig2_timer"](n=64),
        "branch": lambda: P["branch"](prog_len=128),
        "multicore": lambda: P["multicore"](cores=4, prog_len=32),
        "watchdog_pipe": lambda: pkg.dynamic.watchdog_pipe(
            items=96, stages=2, depth=4, poll_gap=16),
    }


HYBRID_SMALL = sorted(_hybrid_small(PORT))


def _both(scenario, *args):
    """Run ``scenario`` on both packages; the port must observe what the
    reference observes.  Returns the port's observation."""
    ref = scenario(REF, *args)
    port = scenario(PORT, *args)
    assert port == ref
    return port


def _obs(r) -> dict:
    """Everything a caller reads from a SimResult, package-free."""
    graph = r.graph.graph
    times = np.asarray(graph.times(), dtype=np.int64)
    return {
        "engine": r.engine,
        "outputs": _normalize(r.outputs),
        "cycles": int(r.cycles),
        "deadlock": bool(r.deadlock),
        "deadlock_cycle": int(r.deadlock_cycle),
        "depths": [int(d) for d in r.depths],
        "stats": {k: int(v) for k, v in vars(r.stats).items()},
        "constraints": [(c.rtype.name, int(c.fifo), int(c.source_seq),
                         int(c.source_node), bool(c.outcome))
                        for c in r.constraints],
        "n_nodes": int(graph.n_nodes), "n_edges": int(graph.n_edges),
        "times": times.tolist(),
        "fifos": [(np.asarray(t.write_times).tolist(),
                   np.asarray(t.read_times).tolist(), list(t.values))
                  for t in r.graph.fifos],
        "hybrid_info": dict(getattr(r.graph, "_hybrid", None) or {}),
    }


def _counters(cache) -> dict:
    return {k: getattr(cache, k) for k in (
        "hits", "misses", "switches", "divergences", "full_hits",
        "full_misses", "full_rejects")}


# ----------------------------------------------------------- exactness sweep
def equals_generator(pkg, name):
    b = _hybrid_small(pkg)[name]
    g = pkg.core.simulate(b(), trace="never")
    h = pkg.core.simulate(b(), trace="auto")
    assert h.engine == "omnisim-hybrid", name
    _assert_bit_identical(g, h, name)
    return _obs(h)


@pytest.mark.parametrize("name", HYBRID_SMALL)
def test_hybrid_equals_generator(name):
    _both(equals_generator, name)


def csr_contract(pkg, name):
    """TraceSimGraph over a segmented run: CSR longest path reproduces the
    eager times (NB_FAIL/PROBE nodes included), and node materialization
    feeds the taxonomy classifier."""
    b = _hybrid_small(pkg)[name]
    h = pkg.core.simulate(b(), trace="auto")
    graph = h.graph.graph
    indptr, src, wgt, base = graph.to_csr()
    np.testing.assert_array_equal(
        pkg.core.longest_path_numpy(indptr, src, wgt, base), graph.times())
    c = pkg.core.classify(b(), h)
    assert c.has_nonblocking, name
    return (indptr.tolist(), src.tolist(), wgt.tolist(), base.tolist(),
            dataclasses.asdict(c))


@pytest.mark.parametrize("name", HYBRID_SMALL)
def test_hybrid_graph_satisfies_csr_contract(name):
    _both(csr_contract, name)


# --------------------------------------------------- downstream incremental
def batch_from_hybrid_base(pkg, name, lane):
    """The pre-built CompiledGraph of a hybrid run drives
    resimulate/resimulate_batch verdict for verdict like a generator
    base."""
    b = _hybrid_small(pkg)[name]
    base_h = pkg.core.simulate(b(), trace="auto")
    base_g = pkg.core.simulate(b(), trace="never")
    assert getattr(base_h.graph, "_incr_cache", None) is not None
    rng = np.random.default_rng(17)
    D = rng.integers(1, 9, size=(12, len(base_h.depths)))
    kw = lane if pkg is PORT else {"backend": "numpy"}
    oh = pkg.core.resimulate_batch(base_h, D, **kw)
    og = pkg.core.resimulate_batch(base_g, D, **kw)
    np.testing.assert_array_equal(oh.ok, og.ok)
    np.testing.assert_array_equal(oh.cycles, og.cycles)
    np.testing.assert_array_equal(oh.status, og.status)
    dv = tuple(int(x) for x in D[0])
    ih = pkg.core.resimulate(base_h, dv)
    full = pkg.core.simulate(b(), depths=dv, trace="never")
    assert ih.result.cycles == full.cycles
    assert ih.result.outputs == full.outputs
    return {"ok": oh.ok.tolist(), "cycles": oh.cycles.tolist(),
            "status": oh.status.tolist(), "violated": oh.violated.tolist(),
            "reasons": list(oh.reasons),
            "results": [None if r is None else (r.engine, r.cycles,
                                                _normalize(r.outputs))
                        for r in oh.results],
            "incremental": (ih.ok, ih.reason, ih.result.cycles)}


@pytest.mark.parametrize("lane", [
    pytest.param({"backend": "numpy"}, id="numpy"),
    pytest.param({"backend": "cuda", "device": "cpu"}, id="cuda-cpu")])
@pytest.mark.parametrize("name", ["fig4_ex5", "fig2_timer", "branch",
                                  "watchdog_pipe"])
def test_resimulate_batch_from_hybrid_base(name, lane):
    _both(batch_from_hybrid_base, name, lane)


# ------------------------------------------------------- segment memoization
def full_replay_skips_generators(pkg):
    cache = pkg.trace.HybridCache()
    b = _hybrid_small(pkg)["fig2_timer"]
    seen = []
    r1 = pkg.core.simulate(b(), trace="auto", hybrid_cache=cache)
    assert cache.hits == 0 and cache.misses == 3
    seen.append(_counters(cache))
    # warm repeat: the whole-run replay serves every row from the verified
    # _FullRun entry — no generator runs, no segment lookups at all
    r2 = pkg.core.simulate(b(), trace="auto", hybrid_cache=cache)
    assert cache.full_hits == 1 and cache.full_rejects == 0
    assert cache.divergences == 0
    assert (r2.graph._hybrid["cache_bulk_rows"] == r2.graph._hybrid["ops"]
            > 0)
    _assert_bit_identical(r1, r2, "full replay")
    seen.append(_counters(cache))
    # the per-module segment cache still drives the periodize=False path
    r3 = pkg.core.simulate(b(), trace="auto", hybrid_cache=cache,
                           periodize=False)
    assert cache.hits == 3 and cache.divergences == 0
    _assert_bit_identical(r1, r3, "segment memo")
    seen.append(_counters(cache))
    return seen, [_obs(r) for r in (r1, r2, r3)]


def test_cache_full_replay_skips_generators():
    _both(full_replay_skips_generators)


def divergence_and_reconvergence(pkg):
    """Perturbed depths flip NB outcomes: the first divergent run
    materializes generators; revisiting a seen depth vector switches back
    to the stored branch instead of re-running them."""
    cache = pkg.trace.HybridCache()
    b = lambda: pkg.paper.PAPER_DESIGNS["fig4_ex4b"](n=64)
    seen = []
    base = pkg.core.simulate(b(), trace="auto", hybrid_cache=cache)
    r1 = pkg.core.simulate(b(), depths=(1,), trace="auto",
                           hybrid_cache=cache)
    assert cache.divergences >= 1
    seen.append(_counters(cache))
    g1 = pkg.core.simulate(b(), depths=(1,), trace="never")
    _assert_bit_identical(g1, r1, "diverged run")
    assert r1.outputs != base.outputs
    before = cache.divergences
    r2 = pkg.core.simulate(b(), depths=(1,), trace="auto",
                           hybrid_cache=cache, periodize=False)
    assert cache.divergences == before
    assert cache.hits + cache.switches >= 2
    _assert_bit_identical(g1, r2, "reconverged run")
    seen.append(_counters(cache))
    r3 = pkg.core.simulate(b(), depths=(1,), trace="auto",
                           hybrid_cache=cache)
    assert cache.full_hits == 1 and cache.full_rejects == 0
    assert cache.divergences == before
    _assert_bit_identical(g1, r3, "full replay at perturbed depths")
    seen.append(_counters(cache))
    return seen, [_obs(r) for r in (base, r1, r2, r3)]


def test_cache_divergence_and_branch_reconvergence():
    _both(divergence_and_reconvergence)


def keys_on_content(pkg):
    """branch(96) and branch(160) share every name; both cache layers key
    on module content, so each size gets its own entries."""
    HybridCache = pkg.trace.HybridCache
    cache = HybridCache()
    b1 = lambda: pkg.paper.PAPER_DESIGNS["branch"](prog_len=96)
    b2 = lambda: pkg.paper.PAPER_DESIGNS["branch"](prog_len=160)
    assert HybridCache.signature(b1()) != HybridCache.signature(b2())
    g2 = pkg.core.simulate(b2(), trace="never")
    r1 = pkg.core.simulate(b1(), trace="always", hybrid_cache=cache)
    r2 = pkg.core.simulate(b2(), trace="always", hybrid_cache=cache)
    assert cache.full_hits == 0
    _assert_bit_identical(g2, r2, "branch(160) after branch(96) warmed")
    assert r1.cycles != r2.cycles and r1.outputs != r2.outputs
    seen = [_counters(cache)]
    w1 = pkg.core.simulate(b1(), trace="always", hybrid_cache=cache)
    w2 = pkg.core.simulate(b2(), trace="always", hybrid_cache=cache)
    assert cache.full_hits == 2 and cache.full_rejects == 0
    _assert_bit_identical(r1, w1, "branch(96) warm")
    _assert_bit_identical(r2, w2, "branch(160) warm")
    seen.append(_counters(cache))
    p1, p2 = b1(), b1()
    p2.fifos[0].depth += 3
    assert HybridCache.signature(p1) == HybridCache.signature(p2)
    return seen, [_obs(r) for r in (r1, r2, w1, w2)]


def test_cache_keys_on_content_not_names():
    _both(keys_on_content)


def rejects_corrupt_entry(pkg):
    """A tampered committed time or a flipped query outcome rejects the
    cached run; the exact protocol then re-stores a clean entry."""
    cache = pkg.trace.HybridCache()
    b = _hybrid_small(pkg)["fig2_timer"]
    seen = []
    r1 = pkg.core.simulate(b(), trace="always", hybrid_cache=cache)
    key = pkg.trace.program_fingerprint(b())
    run = cache.lookup_full(key)
    assert run is not None
    run.times[0][0] += 1
    r2 = pkg.core.simulate(b(), trace="always", hybrid_cache=cache)
    assert cache.full_rejects == 1 and cache.full_hits == 0
    _assert_bit_identical(r1, r2, "fallback after time corruption")
    seen.append(_counters(cache))
    run = cache.lookup_full(key)
    run.cons[0, 5] ^= 1
    r3 = pkg.core.simulate(b(), trace="always", hybrid_cache=cache)
    assert cache.full_rejects == 2 and cache.full_hits == 0
    _assert_bit_identical(r1, r3, "fallback after outcome corruption")
    seen.append(_counters(cache))
    r4 = pkg.core.simulate(b(), trace="always", hybrid_cache=cache)
    assert cache.full_hits == 1
    _assert_bit_identical(r1, r4, "clean warm hit after re-store")
    seen.append(_counters(cache))
    return seen, [_obs(r) for r in (r1, r2, r3, r4)]


def test_full_replay_rejects_corrupt_entry_and_falls_back():
    _both(rejects_corrupt_entry)


def classify_shared_cache(pkg):
    P = pkg.paper.PAPER_DESIGNS
    c = pkg.core.classify_dynamic(lambda: P["fig4_ex4b"](n=64))
    assert c.dtype == "C"
    c2 = pkg.core.classify_dynamic(lambda: P["fig2_timer"](n=64))
    assert c2.dtype == "C"
    c3 = pkg.core.classify_dynamic(lambda: P["fig4_ex2"](n=64))
    assert c3.dtype == "B"
    return [dataclasses.asdict(x) for x in (c, c2, c3)]


def test_classify_dynamic_uses_shared_cache():
    _both(classify_shared_cache)


def _ffwd(d):
    prog = d.Program("ffwd", declared_type="C")
    f = prog.fifo("f", 3)

    @prog.module("p")
    def p():
        dropped = 0
        yield d.Emit("banner", "ffwd")
        for i in range(8):
            yield d.Full(f, used=False)      # dead probe in the prefix
            yield d.Delay(1)
            ok = yield d.WriteNB(f, i)       # outcome flips with depth
            if not ok:
                dropped += 1
        yield d.Emit("dropped", dropped)

    @prog.module("c")
    def c():
        total = 0
        for _ in range(6):
            ok, v = yield d.ReadNB(f)
            if ok:
                total += v
            yield d.Delay(2)
        yield d.Emit("got", total)

    return prog


def fast_forward(pkg):
    """Divergence materialization fast-forwards the fresh generator
    through every yield class in the cached prefix before resuming live
    at the diverged query."""
    cache = pkg.trace.HybridCache()
    base = pkg.core.simulate(_ffwd(pkg.dsl), trace="auto",
                             hybrid_cache=cache)
    seen = [_obs(base)]
    for dv in ((1,), (8,), (2,), (1,)):
        r = pkg.core.simulate(_ffwd(pkg.dsl), depths=dv, trace="auto",
                              hybrid_cache=cache)
        g = pkg.core.simulate(_ffwd(pkg.dsl), depths=dv, trace="never")
        _assert_bit_identical(g, r, dv)
        seen += [_obs(r), _counters(cache)]
    assert cache.divergences >= 1
    assert base.outputs["banner"] == "ffwd"
    return seen


def test_cache_fast_forward_through_probes_and_delays():
    _both(fast_forward)


# ----------------------------------------------------------------- plumbing
def watchdog_info(pkg):
    assert "watchdog_pipe" in pkg.dynamic.DYNAMIC_DESIGNS
    h = pkg.core.simulate(pkg.dynamic.watchdog_pipe(
        items=64, stages=2, depth=4, poll_gap=8), trace="always")
    assert h.engine == "omnisim-hybrid"
    info = h.graph._hybrid
    assert info["queries"] > 0 and info["ops"] > info["queries"]
    assert info["segments"] >= 3
    return _obs(h)


def test_watchdog_registered_and_hybrid_info():
    _both(watchdog_info)


def always_raises_only_when_hybrid_cannot_help(pkg):
    P = pkg.paper.PAPER_DESIGNS
    with pytest.raises(pkg.trace.TraceUnsupported) as e:
        pkg.core.simulate(P["deadlock"](n=8), trace="always")
    r = pkg.core.simulate(P["fig2_timer"](n=32), trace="always")
    assert r.engine == "omnisim-hybrid"
    return str(e.value), e.value.dynamic, _obs(r)


def test_trace_always_raises_only_when_hybrid_cannot_help():
    _both(always_raises_only_when_hybrid_cannot_help)


def direct_entry(pkg):
    P = pkg.paper.PAPER_DESIGNS
    r = pkg.trace.simulate_hybrid(P["branch"](prog_len=64))
    g = pkg.core.simulate(P["branch"](prog_len=64), trace="never")
    _assert_bit_identical(g, r, "direct")
    return _obs(r)


def test_simulate_hybrid_direct_entry():
    _both(direct_entry)
    assert port_core.simulate_hybrid is port_trace.simulate_hybrid
    assert port_core.HybridSim is port_trace.HybridSim


# ------------------------------------------------- batch frontier solver
def _trunc(d):
    prog = d.Program("trunc", declared_type="C")
    data = prog.fifo("data", 2)
    go = prog.fifo("go", 1)

    @prog.module("producer")       # records all 40 writes untimed
    def producer():
        for i in range(40):
            yield d.Write(data, i)
        yield d.Emit("sent", 40)

    @prog.module("consumer")       # parked at the poll while the
    def consumer():                # producer's window runs ahead
        polls = 0
        for _ in range(10):
            ok, _v = yield d.ReadNB(go)
            polls += 1
            if ok:
                break
        total = 0
        for _ in range(40):
            total += (yield d.Read(data))
        yield d.Emit("got", (total, polls))

    return prog


def truncates(pkg):
    """The batch solver truncates the producer's window at the first write
    whose WAR-target read is unrecorded and commits only the validated
    prefix."""
    g = pkg.core.simulate(_trunc(pkg.dsl), trace="never")
    h = pkg.trace.HybridSim(_trunc(pkg.dsl), batch_min=1).run()
    _assert_bit_identical(g, h, "trunc")
    assert h.graph._hybrid["batch_rows"] > 0
    assert g.stats.queries_forced_false == h.stats.queries_forced_false > 0
    return _obs(h)


def test_batch_solver_truncates_at_unrecorded_sources():
    _both(truncates)


def batch_matches_scalar(pkg):
    b = lambda: pkg.dynamic.watchdog_pipe(items=192, stages=3, depth=4,
                                          poll_gap=8)
    g = pkg.core.simulate(b(), trace="never")
    hb = pkg.trace.HybridSim(b(), batch_min=1).run()
    hs = pkg.trace.HybridSim(b(), batch_min=10**9).run()
    _assert_bit_identical(g, hb, "batch")
    _assert_bit_identical(g, hs, "scalar")
    assert hb.graph._hybrid["batch_rows"] > 0
    assert hs.graph._hybrid["batch_rows"] == 0
    np.testing.assert_array_equal(hb.graph.graph.times(),
                                  hs.graph.graph.times())
    return _obs(hb), _obs(hs)


def test_batch_solver_matches_scalar_frontier_on_coupled_pipeline():
    _both(batch_matches_scalar)


def _warcycle(d):
    prog = d.Program("warcycle", declared_type="C")
    x = prog.fifo("x", 1)
    y = prog.fifo("y", 1)
    z = prog.fifo("z", 1)

    @prog.module("a")
    def a():
        ok, _ = yield d.ReadNB(z)   # dynamic: forces the hybrid path
        yield d.Write(x, 0)
        yield d.Write(x, 1)
        v = yield d.Read(y)
        yield d.Emit("a", (ok, v))

    @prog.module("b")
    def b():
        yield d.Write(y, 0)
        yield d.Write(y, 1)
        v = yield d.Read(x)
        yield d.Emit("b", v)

    return prog


def war_cycle(pkg):
    """A WAR cycle inside the provisional window: the batch solver commits
    nothing and the run defers to the generator engine's exact deadlock
    report, with and without the batch solver forced on."""
    msgs = []
    for batch_min in (1, 10**9):
        with pytest.raises(pkg.trace.TraceUnsupported) as e:
            pkg.trace.HybridSim(_warcycle(pkg.dsl), batch_min=batch_min).run()
        msgs.append(str(e.value))
    g = pkg.core.simulate(_warcycle(pkg.dsl), trace="never")
    assert g.deadlock
    a = pkg.core.simulate(_warcycle(pkg.dsl), trace="auto")
    assert a.engine == "omnisim"
    assert a.deadlock and a.deadlock_cycle == g.deadlock_cycle
    assert a.outputs == g.outputs
    return msgs, _obs(a)


def test_batch_solver_war_cycle_defers_to_generator():
    _both(war_cycle)


def periodizer(pkg):
    """Periodized and per-query paths are bit-identical; the knob and the
    stats plumbing report what actually happened."""
    b = lambda: pkg.paper.PAPER_DESIGNS["fig2_timer"](n=192)
    g = pkg.core.simulate(b(), trace="never")
    hp = pkg.trace.simulate_hybrid(b(), periodize=True)
    hn = pkg.trace.simulate_hybrid(b(), periodize=False)
    _assert_bit_identical(g, hp, "periodized")
    _assert_bit_identical(g, hn, "no-periodize")
    assert hp.stats.queries_periodized > 0
    assert hp.graph._hybrid["bulk_queries"] == hp.stats.queries_periodized
    assert hp.graph._hybrid["bursts"] >= 1
    assert hn.stats.queries_periodized == 0
    assert g.stats.queries_periodized == 0
    hp2 = pkg.core.simulate(b(), trace="always", periodize=False)
    _assert_bit_identical(g, hp2, "simulate-knob")
    assert hp2.stats.queries_periodized == 0
    return [_obs(r) for r in (hp, hn, hp2)]


def test_periodizer_stats_and_disable_knob():
    _both(periodizer)


# ------------------------------------------------------- lazy constraints
def lazy_constraints(pkg):
    """A hybrid result's constraint records materialize on first use, and
    every list reader forces them first."""
    r = pkg.core.simulate(_hybrid_small(pkg)["fig4_ex5"](), trace="always")
    lazy = r.constraints
    assert type(lazy).__name__ == "_LazyConstraints"
    assert list.__len__(lazy) == 0             # nothing built yet
    n = len(lazy)
    assert n == r.stats.queries > 0 and list.__len__(lazy) == n
    copy = list(lazy)
    assert copy == lazy and lazy[0] == copy[0] and lazy[-1] in lazy
    other = pkg.core.simulate(_hybrid_small(pkg)["fig4_ex5"](),
                              trace="always").constraints
    assert other == lazy                       # reflected compare forces too
    return n, [tuple(c)[1:] for c in copy[:8]]


def test_lazy_constraints_force_on_every_reader():
    _both(lazy_constraints)


# ------------------------------------------------------------ golden records
# the Type B/C records: the paper's designs and the dynamic corpus (the
# Type A records take the straight-line replay under "auto")
GOLDEN_BC = sorted(set(_golden_designs(port_paper, port_dynamic, port_typea))
                   - set(port_typea.TYPEA_DESIGNS) - {"high_latency_pipe"})
assert len(GOLDEN_BC) == 15


def golden_hybrid(pkg, name, periodize):
    b = _golden_designs(pkg.paper, pkg.dynamic, pkg.typea)[name]
    try:
        h = pkg.trace.simulate_hybrid(b(), periodize=periodize)
    except pkg.trace.TraceUnsupported:
        return None
    return _record(h), h.stats.queries_periodized, h.graph._hybrid


@pytest.mark.parametrize("periodize", [True, False],
                         ids=["periodized", "per-query"])
@pytest.mark.parametrize("name", GOLDEN_BC)
def test_golden_record_through_simulate_hybrid(name, periodize):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    core = {k: golden[k] for k in ("cycles", "deadlock", "deadlock_cycle",
                                   "outputs", "fifo_digest", "n_constraints",
                                   "stats")}
    got = _both(golden_hybrid, name, periodize)
    assert (got is not None) == golden["hybrid_supported"], name
    if got is not None:
        assert got[0] == core, f"{name}: port's hybrid drifted"
        if not periodize:
            assert got[1] == 0


# ---------------------------------------------------- classify_dynamic cases
def _taxonomy_case(pkg, name):
    if name == "producer_consumer":
        return lambda: pkg.typea.producer_consumer(n=32)
    n = 128 if name in ("fig4_ex4a", "fig4_ex4b", "fig4_ex5") else 64
    return lambda: pkg.paper.PAPER_DESIGNS[name](n=n)


TAXONOMY_CASES = {"producer_consumer": "A", "fig4_ex2": "B", "fig4_ex3": "B",
                  "fig2_timer": "C", "fig4_ex4a": "C", "fig4_ex4b": "C",
                  "fig4_ex5": "C"}


def classify_with_cache(pkg, name):
    cache = pkg.trace.HybridCache()
    c = pkg.core.classify_dynamic(_taxonomy_case(pkg, name), cache=cache)
    assert c.dtype == TAXONOMY_CASES[name]
    again = pkg.core.classify_dynamic(_taxonomy_case(pkg, name), cache=cache)
    assert again == c
    return dataclasses.asdict(c), _counters(cache)


@pytest.mark.parametrize("name", sorted(TAXONOMY_CASES))
def test_classify_dynamic_with_a_passed_cache(name):
    """The cases of ``tests/test_taxonomy_dynamic.py`` with one cache
    passed to two classifications: the classification and the cache's
    counters after both equal the reference's."""
    _both(classify_with_cache, name)
