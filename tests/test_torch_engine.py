"""PyTorch port, simulator slice: the generator engine, the compiled graph
and ``resimulate`` against the reference's golden records.

``tests/golden/*.json`` holds the reference generator engine's results —
cycles, deadlock verdict and cycle, outputs, FIFO digests, query and
forced-false stats, plus a depth-variant record.  The port's engine must
reproduce every record bit for bit, and its ``resimulate`` the variant.
The instance parameters below copy ``GOLDEN_DESIGNS`` of
``tests/test_golden.py`` (that module is not imported: it pulls in the
reference's sweep service).
"""
import ast
import hashlib
import json
import os

import numpy as np
import pytest

import repro.core as ref_core
import repro.designs.dynamic as ref_dynamic
import repro.designs.paper as ref_paper
import repro.designs.typea as ref_typea
from repro.designs.typea import skynet_like as ref_skynet_like
import repro_torch.designs.dynamic as port_dynamic
import repro_torch.designs.paper as port_paper
import repro_torch.designs.typea as port_typea
from repro_torch.core import (TraceUnsupported, compile_graph, resimulate,
                              resimulate_batch, simulate, verify_times)
from repro_torch.core.graph import longest_path_numpy
from repro_torch.designs.dynamic import watchdog_pipe
from repro_torch.designs.paper import PAPER_DESIGNS
from repro_torch.designs.typea import producer_consumer, skynet_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def _golden_designs(paper, dynamic, typea):
    """The golden instances, built from one package's design modules."""
    P = paper.PAPER_DESIGNS
    return {
        "fig4_ex2": lambda: P["fig4_ex2"](n=96),
        "fig4_ex3": lambda: P["fig4_ex3"](n=96),
        "fig4_ex4a": lambda: P["fig4_ex4a"](n=96),
        "fig4_ex4a_d": lambda: P["fig4_ex4a_d"](n=96),
        "fig4_ex4b": lambda: P["fig4_ex4b"](n=96),
        "fig4_ex4b_d": lambda: P["fig4_ex4b_d"](n=96),
        "fig4_ex5": lambda: P["fig4_ex5"](n=96),
        "fig2_timer": lambda: P["fig2_timer"](n=96),
        "deadlock": lambda: P["deadlock"](n=16),
        "branch": lambda: P["branch"](prog_len=128),
        "multicore": lambda: P["multicore"](cores=4, prog_len=32),
        "watchdog_pipe": lambda: dynamic.watchdog_pipe(
            items=96, stages=2, depth=4, poll_gap=16),
        "fig2_poll_burst": lambda: dynamic.fig2_poll_burst(
            items=96, stages=2, depth=4),
        "multisite_poll": lambda: dynamic.multisite_poll(items=96, depth=16),
        "nb_success_stream": lambda: dynamic.nb_success_stream(items=96,
                                                               depth=16),
        "producer_consumer": lambda: typea.producer_consumer(n=64),
        "fir_filter": lambda: typea.fir_filter(n=96, taps=4),
        "parallel_loops": lambda: typea.parallel_loops(n=64),
        "merge_sort_staged": lambda: typea.merge_sort_staged(log_n=4),
        "skynet_like": lambda: typea.skynet_like(items=96, depth=8),
        "high_latency_pipe": lambda: typea.high_latency_pipe(
            items=24, stages=3, ii=16),
    }


GOLDEN_DESIGNS = _golden_designs(port_paper, port_dynamic, port_typea)
REF_GOLDEN_DESIGNS = _golden_designs(ref_paper, ref_dynamic, ref_typea)


def _normalize(obj):
    if isinstance(obj, dict):
        return {str(k): _normalize(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def _fifo_digest(result) -> str:
    h = hashlib.sha256()
    for tbl in result.graph.fifos:
        h.update(np.sort(np.asarray(tbl.write_times, np.int64)).tobytes())
        h.update(b"|")
        h.update(np.sort(np.asarray(tbl.read_times, np.int64)).tobytes())
        h.update(b"|")
        h.update(repr(list(tbl.values)).encode())
        h.update(b"#")
    return h.hexdigest()


def _record(result) -> dict:
    return {
        "cycles": int(result.cycles),
        "deadlock": bool(result.deadlock),
        "deadlock_cycle": int(result.deadlock_cycle),
        "outputs": _normalize(result.outputs),
        "fifo_digest": _fifo_digest(result),
        "n_constraints": len(result.constraints),
        "stats": {
            "nodes": int(result.stats.nodes),
            "edges": int(result.stats.edges),
            "queries": int(result.stats.queries),
            "queries_forced_false": int(result.stats.queries_forced_false),
            "skipped_probes": int(result.stats.skipped_probes),
        },
    }


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def test_golden_list_matches_reference_records():
    have = {f[:-5] for f in os.listdir(GOLDEN_DIR) if f.endswith(".json")}
    have.discard("corpus_seeds")
    assert have == set(GOLDEN_DESIGNS)
    assert len(GOLDEN_DESIGNS) == 21


@pytest.mark.parametrize("name", sorted(GOLDEN_DESIGNS))
def test_port_reproduces_golden_record(name):
    """Generator engine (``trace="never"``), ``"auto"`` (the engine the
    reference's ``"auto"`` takes: compiled replay, hybrid replay or the
    generator engine), ``resimulate`` on the variant depths, and
    ``resimulate_batch`` on the host lane, all bit-identical to the
    reference's record."""
    golden = _golden(name)
    core = {k: golden[k] for k in ("cycles", "deadlock", "deadlock_cycle",
                                   "outputs", "fifo_digest", "n_constraints",
                                   "stats")}
    make = GOLDEN_DESIGNS[name]
    g = simulate(make(), trace="never")
    assert _record(g) == core, f"{name}: port's generator engine drifted"
    assert [int(d) for d in g.depths] == golden["depths"]
    a = simulate(make(), trace="auto")
    ref_engine = ref_core.simulate(REF_GOLDEN_DESIGNS[name](),
                                   trace="auto").engine
    assert a.engine == ref_engine
    assert _record(a) == core, f"{name}: auto path drifted"
    if "variant" not in golden:
        return
    dv = tuple(golden["variant_depths"])
    vref = golden["variant"]
    inc = resimulate(a, dv)
    assert int(inc.result.cycles) == vref["cycles"], name
    assert bool(inc.result.deadlock) == vref["deadlock"], name
    assert _normalize(inc.result.outputs) == vref["outputs"], name
    out = resimulate_batch(g, np.asarray([dv, golden["depths"]]),
                           backend="numpy")
    assert int(out.cycles[0]) == vref["cycles"], name
    assert int(out.cycles[1]) == golden["cycles"], name


def test_finalization_and_verify_times_agree_with_eager_times():
    res = simulate(skynet_like(items=32, depth=4))
    engine = res.graph
    indptr, src, wgt, base = engine.graph.to_csr()
    eager = engine.graph.times()
    assert (longest_path_numpy(indptr, src, wgt, base) == eager).all()
    assert verify_times(compile_graph(engine), eager, res.depths) is None
    bumped = eager.copy()
    bumped[-1] += 1
    assert verify_times(compile_graph(engine), bumped, res.depths)


def test_shuffled_servicing_order_gives_the_same_result():
    base = simulate(PAPER_DESIGNS["fig4_ex5"](n=64), trace="never")
    for seed in (0, 1, 7):
        shuf = simulate(PAPER_DESIGNS["fig4_ex5"](n=64), shuffle_seed=seed)
        assert _record(shuf) == _record(base)


def test_trace_always_takes_compiled_replay():
    res = simulate(producer_consumer(n=8), trace="always")
    assert res.engine == "omnisim-trace"
    assert res.outputs == simulate(producer_consumer(n=8),
                                   trace="never").outputs
    with pytest.raises(ValueError):
        simulate(producer_consumer(n=8), trace="sometimes")


def test_trace_always_raises_where_the_replay_defers():
    """A design compiled replay cannot run: ``"always"`` raises
    ``TraceUnsupported``, as in the reference; ``"auto"`` falls back."""
    dl = PAPER_DESIGNS["deadlock"]
    with pytest.raises(TraceUnsupported):
        simulate(dl(n=8), trace="always")
    assert simulate(dl(n=8), trace="auto").engine == "omnisim"


def test_trace_always_on_an_nb_design_names_hybrid_replay():
    """An NB design: ``"always"`` takes the hybrid replay (engine
    ``"omnisim-hybrid"``) as the reference does, not ``TraceUnsupported``,
    and gives what ``"auto"`` and the generator engine give."""
    def build():
        return watchdog_pipe(items=16, stages=2, depth=4, poll_gap=16)
    always = simulate(build(), trace="always")
    assert always.engine == "omnisim-hybrid"
    auto = simulate(build(), trace="auto")
    assert auto.engine == "omnisim-hybrid"
    assert _record(always) == _record(auto) == _record(
        simulate(build(), trace="never"))
    ref = ref_core.simulate(ref_dynamic.watchdog_pipe(
        items=16, stages=2, depth=4, poll_gap=16), trace="always")
    assert ref.engine == "omnisim-hybrid" and _record(ref) == _record(always)


def test_trace_always_with_shuffle_seed_is_an_error():
    with pytest.raises(ValueError, match="shuffle_seed"):
        simulate(producer_consumer(n=8), shuffle_seed=1, trace="always")
    assert simulate(producer_consumer(n=8),
                    shuffle_seed=1).engine == "omnisim"


def test_simulate_writes_depths_into_the_program():
    prog = producer_consumer(n=16, depth=2)
    res = simulate(prog, depths=(5,))
    assert prog.depths() == (5,) and res.depths == (5,)


def test_compiled_graph_matches_reference_field_for_field():
    """Same design, same node numbering: the port's compiled graph equals
    the reference's array for array."""
    mine = compile_graph(simulate(skynet_like(items=24, depth=4),
                                  trace="never").graph)
    theirs = ref_core.compile_graph(
        ref_core.simulate(ref_skynet_like(items=24, depth=4),
                          trace="never").graph)
    assert mine.n == theirs.n
    for f in ("raw_dst", "raw_src", "raw_w", "base", "seq_w", "c_kind",
              "c_fifo", "c_seq", "c_src", "c_out"):
        assert np.array_equal(getattr(mine, f), getattr(theirs, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(mine.chains,
                                                    theirs.chains))
    for (w1, r1, b1), (w2, r2, b2) in zip(mine.fifos, theirs.fifos):
        assert np.array_equal(w1, w2) and np.array_equal(r1, r2)
        assert np.array_equal(b1, b2)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[0])
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
