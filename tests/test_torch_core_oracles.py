"""PyTorch port, seventh slice: the rest of core — the cycle-stepped RTL
oracle (``simulate_rtl``), the LightningSim baseline and C-sim
(``lightningsim``), the Type A/B/C taxonomy (``classify``,
``classify_dynamic``) and the AXI models (``axi``).

Each design is built once in each package from the same function, run
through ``repro.core`` and ``repro_torch.core``, and the answers must be
equal: outputs, cycles, deadlock verdicts, the errors raised, and the
classifications field for field.  The designs are those the reference's
own tests use for these modules (``tests/test_engine.py``,
``test_designs.py``, ``test_axi.py``, ``test_taxonomy_dynamic.py``), at
their sizes, but for ``skynet_like`` (512 of its 2048 items) and the C-sim
op budget (100 k of 10 M ops, on both sides).
"""
import dataclasses

import pytest

import repro.core as R
import repro.core.axi as raxi
import repro.core.program as rdsl
import repro.designs.dynamic as rdynamic
import repro.designs.paper as rpaper
import repro.designs.typea as rtypea
import repro_torch.core as T
import repro_torch.core.axi as taxi
import repro_torch.core.program as tdsl
import repro_torch.designs.dynamic as tdynamic
import repro_torch.designs.paper as tpaper
import repro_torch.designs.typea as ttypea


# --------------------------- the hand-built designs of tests/test_engine.py
def _pc(d, n=16, depth=2, delay=0):
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


def _nbdrop(d):
    prog = d.Program("nbdrop", declared_type="C")
    f = prog.fifo("f", 1)

    @prog.module("p")
    def p():
        sent = 0
        for i in range(10):
            ok = yield d.WriteNB(f, i)
            if ok:
                sent += 1
        yield d.Emit("sent", sent)

    @prog.module("c")
    def c():
        got = []
        for _ in range(3):
            v = yield d.Read(f)
            got.append(v)
            yield d.Delay(2)
        yield d.Emit("got", tuple(got))

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
            ok, v = yield d.ReadNB(f)
            polls += 1
            if ok:
                break
        yield d.Emit("polls", polls)
        yield d.Emit("v", v)

    return prog


def _probe(d):
    prog = d.Program("probe", declared_type="C")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        outcomes = []
        for i in range(6):
            full = yield d.Full(f)
            outcomes.append(full)
            if not full:
                yield d.Write(f, i)
        yield d.Emit("full_seq", tuple(outcomes))

    @prog.module("c")
    def c():
        got = 0
        for _ in range(3):
            yield d.Read(f)
            got += 1
            yield d.Delay(5)
        yield d.Emit("got", got)

    return prog


def _deadlock(d):
    prog = d.Program("dl", declared_type="B")
    ab = prog.fifo("ab", 1)
    ba = prog.fifo("ba", 1)

    @prog.module("a")
    def a():
        v = yield d.Read(ba)
        yield d.Write(ab, v)

    @prog.module("b")
    def b():
        v = yield d.Read(ab)
        yield d.Write(ba, v)

    return prog


def _undersized(d, depth):
    prog = d.Program("dl2", declared_type="B")
    req = prog.fifo("req", depth)
    resp = prog.fifo("resp", 2)

    @prog.module("ctrl")
    def ctrl():
        total = 0
        for i in range(3):
            yield d.Write(req, i)
        for i in range(3):
            total += (yield d.Read(resp))
        yield d.Emit("total", total)

    @prog.module("proc")
    def proc():
        for _ in range(3):
            v = yield d.Read(req)
            yield d.Write(resp, v * 10)

    return prog


def _mutual_poll(d):
    prog = d.Program("mutual_poll", declared_type="C")
    ab = prog.fifo("ab", 1)
    ba = prog.fifo("ba", 1)

    @prog.module("a")
    def a():
        sent = False
        while True:
            ok, _ = yield d.ReadNB(ba)
            if ok:
                break
            if not sent:
                yield d.WriteNB(ab, 1)
                sent = True
        yield d.Emit("a_done", True)

    @prog.module("b")
    def b():
        while True:
            ok, _ = yield d.ReadNB(ab)
            if ok:
                break
        yield d.WriteNB(ba, 2)
        yield d.Emit("b_done", True)

    return prog


def _tie(d, polls):
    prog = d.Program("tie", declared_type="C")
    ab = prog.fifo("ab", 1)
    ba = prog.fifo("ba", 1)

    @prog.module("a")
    def a():
        hits = 0
        for _ in range(polls):
            ok, _v = yield d.ReadNB(ba)
            hits += int(ok)
        yield d.WriteNB(ab, 1)
        yield d.Emit("a_hits", hits)

    @prog.module("b")
    def b():
        hits = 0
        for _ in range(polls):
            ok, _v = yield d.ReadNB(ab)
            hits += int(ok)
        yield d.WriteNB(ba, 2)
        yield d.Emit("b_hits", hits)

    return prog


def _flip(d):
    prog = d.Program("flip", declared_type="C")
    sig = prog.fifo("sig", 2)

    @prog.module("poller")
    def poller():
        hits = 0
        polls = 0
        while hits < 2 and polls < 60:
            ok, _v = yield d.ReadNB(sig)
            polls += 1
            hits += int(ok)
        yield d.Emit("polls", polls)
        yield d.Emit("hits", hits)

    @prog.module("writer")
    def writer():
        yield d.Delay(17)
        yield d.Write(sig, 1)
        yield d.Delay(23)
        yield d.Write(sig, 2)

    return prog


def _dead_probe(d, used):
    prog = d.Program("deadprobe", declared_type="C")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        for i in range(4):
            yield d.Full(f, used=used)
            yield d.Write(f, i)

    @prog.module("c")
    def c():
        total = 0
        for _ in range(4):
            total += (yield d.Read(f))
        yield d.Emit("total", total)

    return prog


def _nb_pair(d):
    prog = d.Program("nb", declared_type="C")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        yield d.WriteNB(f, 1)

    @prog.module("c")
    def c():
        yield d.ReadNB(f)

    return prog


def _memory_pipe(d, axi):
    """``make_axi_port`` and ``make_memory``: a master reads two bursts and
    writes one back through the blocking memory model."""
    prog = d.Program("axi_mem", declared_type="A")
    port = axi.make_axi_port(prog, "m", depth=2)
    axi.make_memory(prog, port, list(range(40, 56)), read_latency=5,
                    write_latency=3, n_reads=2, n_writes=1)

    @prog.module("master")
    def master():
        total = 0
        for b in range(2):
            yield d.Write(port.ar, (8 * b, 8))
            for _ in range(8):
                total += (yield d.Read(port.r))
        yield d.Write(port.aw, (4, 4))
        for i in range(4):
            yield d.Write(port.w, -i)
        yield d.Read(port.b)
        yield d.Emit("total", total)

    return prog


def _reactive_pipe(d, axi):
    """``make_reactive_memory``: the NB-polling memory, shut down by a write
    to address 0."""
    prog = d.Program("axi_reactive", declared_type="B")
    port = axi.make_axi_port(prog, "m", depth=2)
    axi.make_reactive_memory(prog, port, list(range(16)), read_latency=4)

    @prog.module("master")
    def master():
        yield d.Write(port.ar, (4, 4))
        got = []
        for _ in range(4):
            got.append((yield d.Read(port.r)))
        yield d.Write(port.aw, (0, 1))
        yield d.Write(port.w, 99)
        yield d.Read(port.b)
        yield d.Emit("got", tuple(got))

    return prog


def _hand_built():
    designs = {
        "pc": lambda d: _pc(d),
        "nbdrop": _nbdrop,
        "poll": _poll,
        "probe": _probe,
        "deadlock_ab": _deadlock,
        "undersized_2": lambda d: _undersized(d, 2),
        "undersized_3": lambda d: _undersized(d, 3),
        "mutual_poll": _mutual_poll,
        "tie": lambda d: _tie(d, 6),
        "tie_periodized": lambda d: _tie(d, 14),
        "flip": _flip,
        "dead_probe_used": lambda d: _dead_probe(d, True),
        "dead_probe_unused": lambda d: _dead_probe(d, False),
        "nb_pair": _nb_pair,
        "pc_stalls": lambda d: _pc(d, n=64, depth=1, delay=3),
    }
    for depth in (1, 2, 3, 7, 100):
        for delay in (0, 1, 3):
            designs[f"pc_d{depth}_delay{delay}"] = (
                lambda d, depth=depth, delay=delay: _pc(d, depth=depth,
                                                        delay=delay))
    return designs


def _pair(make):
    return (lambda: make(tdsl), lambda: make(rdsl))


# name -> (port design function, reference design function)
DESIGNS = {f"engine/{k}": _pair(v) for k, v in _hand_built().items()}
DESIGNS.update({f"paper/{k}": (v, rpaper.PAPER_DESIGNS[k])
                for k, v in tpaper.PAPER_DESIGNS.items()})
DESIGNS.update({f"typea/{k}": (v, rtypea.TYPEA_DESIGNS[k])
                for k, v in ttypea.TYPEA_DESIGNS.items()})
# skynet_like at a quarter of its 2048 items: LightningSim's phase 2 and
# the taxonomy's node objects cost seconds a run at the default
DESIGNS["typea/skynet_like"] = (lambda: ttypea.skynet_like(items=512),
                                lambda: rtypea.skynet_like(items=512))
DESIGNS.update({
    "axi/master": (taxi.axi_master_design, raxi.axi_master_design),
    "axi/master_lat4": (lambda: taxi.axi_master_design(read_latency=4),
                        lambda: raxi.axi_master_design(read_latency=4)),
    "axi/master_lat40": (lambda: taxi.axi_master_design(read_latency=40),
                         lambda: raxi.axi_master_design(read_latency=40)),
    "axi/prefetch": (taxi.axi_prefetch_design, raxi.axi_prefetch_design),
    "axi/memory": (lambda: _memory_pipe(tdsl, taxi),
                   lambda: _memory_pipe(rdsl, raxi)),
    "axi/reactive": (lambda: _reactive_pipe(tdsl, taxi),
                     lambda: _reactive_pipe(rdsl, raxi)),
})
DESIGNS.update({f"dynamic/{k}": (v, rdynamic.DYNAMIC_DESIGNS[k])
                for k, v in tdynamic.DYNAMIC_DESIGNS.items()})
NAMES = sorted(DESIGNS)
# designs the reference's own tests hold against the RTL oracle
RTL_CHECKED = [n for n in NAMES if not n.startswith("dynamic/")]


def _outcome(fn):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(), None
    except Exception as exc:                  # noqa: BLE001 — compared
        return None, (type(exc).__name__, str(exc))


def _same_sim(a, b):
    assert (a.program, a.engine, a.cycles, a.deadlock, a.deadlock_cycle,
            tuple(a.depths)) == (b.program, b.engine, b.cycles, b.deadlock,
                                 b.deadlock_cycle, tuple(b.depths))
    assert a.outputs == b.outputs


# ------------------------------------------------------------- RTL oracle
@pytest.mark.parametrize("name", NAMES)
def test_simulate_rtl_matches_reference(name):
    mine_b, ref_b = DESIGNS[name]
    _same_sim(T.simulate_rtl(mine_b()), R.simulate_rtl(ref_b()))


@pytest.mark.parametrize("name", RTL_CHECKED)
def test_simulate_matches_rtl_oracle(name):
    """The port's ``simulate`` (compiled replay or the generator engine)
    against its own RTL oracle: same deadlock verdict, and without one the
    same outputs and cycles — the reference tests' contract."""
    mine_b, _ = DESIGNS[name]
    sim, rtl = T.simulate(mine_b()), T.simulate_rtl(mine_b())
    assert sim.deadlock == rtl.deadlock
    if not sim.deadlock:
        assert sim.outputs == rtl.outputs
        assert sim.cycles == rtl.cycles


def test_simulate_rtl_writes_depths_and_budget():
    prog = _pc(tdsl, depth=2)
    r = T.simulate_rtl(prog, depths=(5,))
    assert prog.depths() == (5,) and r.depths == (5,)
    assert r.cycles == R.simulate_rtl(_pc(rdsl), depths=(5,)).cycles
    with pytest.raises(RuntimeError, match="cycle budget"):
        T.simulate_rtl(_pc(tdsl, n=64, delay=3), max_cycles=10)


# ------------------------------------------------------------ LightningSim
@pytest.mark.parametrize("name", NAMES)
def test_lightningsim_matches_reference(name):
    """Same result where the reference's runs, the same
    ``UnsupportedDesignError`` (and message) where it refuses."""
    mine_b, ref_b = DESIGNS[name]
    a, a_err = _outcome(lambda: T.LightningSim(mine_b()).run())
    b, b_err = _outcome(lambda: R.LightningSim(ref_b()).run())
    assert a_err == b_err
    if b_err is not None:
        assert b_err[0] == "UnsupportedDesignError"
        return
    _same_sim(a, b)
    assert sorted(a.stats) == sorted(b.stats) == ["phase1_s", "phase2_s"]


@pytest.mark.parametrize("name", sorted(rtypea.TYPEA_DESIGNS))
def test_lightningsim_phases_match_reference(name):
    """Phase 1's event list and phase 2's times, and the incremental
    re-run under other depths, equal the reference's; on Type A designs
    all three engines agree."""
    mine_b, ref_b = DESIGNS[f"typea/{name}"]
    mine, theirs = T.LightningSim(mine_b()), R.LightningSim(ref_b())
    ta, tb = mine.phase1(), theirs.phase1()
    assert [dataclasses.astuple(e) for e in ta.events] == \
        [dataclasses.astuple(e) for e in tb.events]
    assert (ta.end_gap, ta.outputs) == (tb.end_gap, tb.outputs)
    ca, times_a = mine.phase2()
    cb, times_b = theirs.phase2()
    assert ca == cb and (times_a == times_b).all()
    depths = tuple(d + 1 for d in mine.program.depths())
    ra, rb = mine.resimulate(depths), theirs.resimulate(depths)
    assert (ra.engine, ra.cycles, ra.outputs, tuple(ra.depths)) == \
        (rb.engine, rb.cycles, rb.outputs, tuple(rb.depths))
    full = T.LightningSim(mine_b()).run()
    sim, rtl = T.simulate(mine_b()), T.simulate_rtl(mine_b())
    assert full.outputs == sim.outputs == rtl.outputs
    assert full.cycles == sim.cycles == rtl.cycles
    assert sim.engine == "omnisim-trace"


@pytest.mark.parametrize("name", sorted(tpaper.PAPER_DESIGNS))
def test_lightningsim_cannot_simulate_paper_designs(name):
    with pytest.raises(T.UnsupportedDesignError):
        T.LightningSim(tpaper.PAPER_DESIGNS[name]()).run()


# ------------------------------------------------------------------- C-sim
@pytest.mark.parametrize("name", NAMES)
def test_csim_matches_reference(name):
    """Same record, or the same error where the sequential run breaks the
    design (a module reading a request before its master wrote one).  The
    op budget is cut from 10 M to 100 k, on both sides: the designs that
    poll forever then crash at 100 k ops instead of 10 M."""
    mine_b, ref_b = DESIGNS[name]
    a, a_err = _outcome(lambda: T.csim(mine_b(), max_ops=100_000))
    b, b_err = _outcome(lambda: R.csim(ref_b(), max_ops=100_000))
    assert a_err == b_err
    if b_err is None:
        _same_sim(a, b)


def test_table3_csim_failures():
    """The C-sim column of Table 3 (the values
    ``tests/test_designs.py::test_table3_csim_failures`` pins)."""
    P = tpaper.PAPER_DESIGNS
    for name in ("fig4_ex2", "fig4_ex4a_d", "fig4_ex4b_d"):
        r = T.csim(P[name]())
        assert r.outputs.get("__crash__") == "@E Simulation failed: SIGSEGV."
        assert r.cycles == -1 and r.engine == "csim"
    r = T.csim(P["fig4_ex3"]())
    assert r.outputs["sum"] == 0
    assert sum("read while empty" in w
               for w in r.outputs["__warnings__"]) == 2025
    assert any("leftover" in w for w in r.outputs["__warnings__"])
    assert T.csim(P["fig4_ex4a"]()).outputs["sum_out"] == 2051325
    assert T.csim(P["fig4_ex4b"]()).outputs == {"sum_out": 2051325,
                                                "Dropped": 0}
    assert T.csim(P["fig2_timer"]()).outputs["timer_cycles"] == 0


def test_csim_crash_on_a_runaway_loop():
    """``CSimCrash`` is the op budget's SIGSEGV; ``csim`` reports it as the
    crash record, as the reference does."""
    assert issubclass(T.CSimCrash, RuntimeError)
    r = T.csim(_pc(tdsl, n=64), max_ops=10)
    assert r.outputs == {"__crash__": "@E Simulation failed: SIGSEGV."}
    assert r.outputs == R.csim(_pc(rdsl, n=64), max_ops=10).outputs


# ---------------------------------------------------------------- taxonomy
@pytest.mark.parametrize("name", NAMES)
def test_classify_matches_reference(name):
    """``classify`` on the port's own run (compiled replay or generator),
    and with no run supplied, equals the reference's classification."""
    mine_b, ref_b = DESIGNS[name]
    prog = mine_b()
    a = T.classify(prog, T.simulate(mine_b()))
    rprog = ref_b()
    b = R.classify(rprog, R.simulate(ref_b()))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert str(a) == str(b)
    assert dataclasses.asdict(T.classify(mine_b())) == dataclasses.asdict(b)


def test_table4_design_inventory():
    mc = tpaper.PAPER_DESIGNS["multicore"]()
    assert (len(mc.modules), len(mc.fifos)) == (34, 64)
    c = T.classify(mc, T.simulate(tpaper.PAPER_DESIGNS["multicore"]()))
    assert c.dtype == "C" and c.cyclic and c.has_nonblocking
    ex3 = tpaper.PAPER_DESIGNS["fig4_ex3"]
    c3 = T.classify(ex3(), T.simulate(ex3()))
    assert c3.dtype == "B" and c3.cyclic and not c3.has_nonblocking
    c_axi = T.classify(taxi.axi_master_design())
    assert c_axi.dtype == "B" and c_axi.cyclic


_DYNAMIC_CASES = {
    "producer_consumer": "A",
    "fig4_ex2": "B",
    "fig4_ex3": "B",
    "fig2_timer": "C",
    "fig4_ex4a": "C",
    "fig4_ex4b": "C",
    "fig4_ex5": "C",
}


def _dynamic_design(name, typea, paper):
    if name == "producer_consumer":
        return lambda: typea.producer_consumer(n=32)
    n = 128 if name in ("fig4_ex4a", "fig4_ex4b", "fig4_ex5") else 64
    return lambda: paper.PAPER_DESIGNS[name](n=n)


@pytest.mark.parametrize("name", sorted(_DYNAMIC_CASES))
def test_classify_dynamic_matches_reference(name):
    """The cases of ``tests/test_taxonomy_dynamic.py``: the port's probes
    share the cache ``classify_dynamic`` builds and reach the reference's
    classification."""
    a = T.classify_dynamic(_dynamic_design(name, ttypea, tpaper))
    b = R.classify_dynamic(_dynamic_design(name, rtypea, rpaper))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.dtype == _DYNAMIC_CASES[name]


def test_classify_dynamic_with_a_cache_is_not_ported_yet():
    """A passed ``HybridCache`` is used, as in the reference: after
    classifying a dynamic design its counters equal the reference's."""
    counts = []
    for core, paper in ((T, tpaper), (R, rpaper)):
        cache = core.HybridCache()
        c = core.classify_dynamic(lambda: paper.fig4_ex4b(n=64), cache=cache)
        assert c.dtype == "C"
        counts.append((cache.hits, cache.misses, cache.switches,
                       cache.divergences, cache.full_hits, cache.full_misses,
                       cache.full_rejects))
    assert counts[0] == counts[1] and counts[0][1] > 0


# --------------------------------------------------------------------- AXI
def test_axi_master_matches_oracle_and_doubles_memory():
    r1 = T.simulate(taxi.axi_master_design())
    r2 = T.simulate_rtl(taxi.axi_master_design())
    assert r1.engine == "omnisim-trace"
    assert (r1.outputs, r1.cycles) == (r2.outputs, r2.cycles)
    data = [(i * 7 + 3) % 97 for i in range(64)]
    assert list(r1.outputs["memory_final"]) == [2 * v for v in data]
    fast = T.simulate(taxi.axi_master_design(read_latency=4)).cycles
    slow = T.simulate(taxi.axi_master_design(read_latency=40)).cycles
    assert slow - fast == 4 * 36


def test_axi_prefetch_is_type_c_and_exercises_backpressure():
    r1 = T.simulate(taxi.axi_prefetch_design())
    assert r1.outputs["prefetch_skipped"] > 0
    for seed in (0, 1):
        r = T.simulate(taxi.axi_prefetch_design(), shuffle_seed=seed)
        assert (r.outputs, r.cycles) == (r1.outputs, r1.cycles)
    assert T.classify(taxi.axi_prefetch_design()).dtype == "C"


def test_axi_port_channels_match_reference():
    mine = taxi.make_axi_port(tdsl.Program("p"), "g", depth=3)
    theirs = raxi.make_axi_port(rdsl.Program("p"), "g", depth=3)
    for ch in ("ar", "r", "aw", "w", "b"):
        a, b = getattr(mine, ch), getattr(theirs, ch)
        assert (a.name, a.depth, a.fid) == (b.name, b.depth, b.fid)
