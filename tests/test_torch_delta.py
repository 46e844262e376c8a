"""PyTorch port, ninth slice: structural deltas and edit sessions
(``repro_torch.delta``; ``GraphCache.get_or_patch``,
``SweepService.edit_session``) against the reference's (``repro.delta``).

The contract is the reference's: an edit served through the delta layer is
bit-identical to simulating the edited design from scratch, or it rejects
to a cold rebuild.  Every tier-1 case of the reference's
``tests/test_delta.py`` is written once, as a function of a package
(``REF``: ``repro``; ``PORT``: ``repro_torch``), runs on both from the
same edit pairs (``edit_pairs(3, scale=28)``), and returns what it
observed: delta classifications module by module, patch modes, reasons and
reused modules, cache counters, session modes and counts, and the
``result_record`` of every served result.  The port's observation must
equal the reference's.  Fingerprints hash each package's own bytecode, so
keys are compared only within a package.  Services run in manual mode; the
port's on ``backend="cuda", device="cpu"`` (the kernel's plain version)
and on ``backend="numpy"``, the reference's on ``"numpy"``.  The
300-module differential keeps the reference's opt-in marker (``-m
delta``).
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.program as ref_dsl
import repro.core.trace as ref_trace
import repro.corpus as ref_corpus
import repro.delta as ref_delta
import repro.sweep as ref_sweep
import repro_torch.core as port_core
import repro_torch.core.program as port_dsl
import repro_torch.core.trace as port_trace
import repro_torch.corpus as port_corpus
import repro_torch.delta as port_delta
import repro_torch.sweep as port_sweep
import repro_torch.sweep.cache as port_cache

REF = SimpleNamespace(core=ref_core, dsl=ref_dsl, trace=ref_trace,
                      corpus=ref_corpus, delta=ref_delta, sweep=ref_sweep,
                      lane={"backend": "numpy"})
PORT = SimpleNamespace(core=port_core, dsl=port_dsl, trace=port_trace,
                       corpus=port_corpus, delta=port_delta, sweep=port_sweep)
PORT_LANES = [
    pytest.param({"backend": "cuda", "device": "cpu"}, id="cuda-cpu"),
    pytest.param({"backend": "numpy"}, id="numpy")]
_PAIRS = {}


def _port(lane=None):
    return SimpleNamespace(**vars(PORT), lane=lane or {"backend": "numpy"})


def _pairs(pkg):
    """One probe-selected base design, all seven edit classes on it."""
    key = pkg.corpus.__name__
    if key not in _PAIRS:
        _PAIRS[key] = {p.kind: p for p in pkg.corpus.edit_pairs(3, scale=28)}
    return _PAIRS[key]


def _service(pkg, **kw):
    kw.setdefault("autostart", False)
    return pkg.sweep.SweepService(**pkg.lane, **kw)


def _both(scenario, *args, lane=None):
    """Run ``scenario`` on both packages; their observations must agree."""
    got = scenario(_port(lane), *args)
    want = scenario(REF, *args)
    assert got == want
    return got


def _cache_stats(cache):
    st = cache.stats()
    return {k: st[k] for k in ("size", "hits", "misses", "evictions",
                               "delta_hits", "delta_rejects", "full_runs")}


def _depth_block(prog, rows=4):
    d0 = np.asarray(prog.depths(), dtype=np.int64)
    return np.stack([np.maximum(d0 + k, 1) for k in range(rows)])


def _seen(out):
    return {"status": out.status.tolist(), "cycles": out.cycles.tolist(),
            "violated": out.violated.tolist(),
            "results": [None if r is None else (r.cycles, r.outputs,
                                                r.deadlock)
                        for r in out.results]}


def _delta_seen(d):
    return {"modules": d.modules, "fifos": d.fifos, "patchable": d.patchable,
            "reason": d.reason, "edited": d.edited,
            "identical": d.identical, "n_unchanged": d.n_unchanged,
            "summary": d.summary()}


def _poll_design(pkg, name, d=10, value=42):
    """The reference test's NB polling design (dynamic: no snapshot)."""
    Delay, Emit, ReadNB, Write = (pkg.dsl.Delay, pkg.dsl.Emit,
                                  pkg.dsl.ReadNB, pkg.dsl.Write)
    prog = pkg.dsl.Program(name, declared_type="B")
    f = prog.fifo("f", 2)

    @prog.module("p")
    def p():
        yield Delay(d)
        yield Write(f, value)

    @prog.module("c")
    def c():
        polls = 0
        while True:
            ok, _v = yield ReadNB(f)
            polls += 1
            if ok:
                break
        yield Emit("polls", polls)
    return prog


# ---------------------------------------------------------- fingerprint/diff
def test_pairs_are_the_reference_pairs():
    for kind in port_corpus.EDIT_KINDS:
        p, r = _pairs(PORT)[kind], _pairs(REF)[kind]
        assert (p.kind, p.name, p.expect, p.detail) == (
            r.kind, r.name, r.expect, r.detail)
        for side in ("base", "edited"):
            a, b = getattr(p, side)(), getattr(r, side)()
            assert [(f.name, f.depth) for f in a.fifos] == [
                (f.name, f.depth) for f in b.fifos]
            assert [m.name for m in a.modules] == [m.name for m in b.modules]
    assert port_corpus.EDIT_KINDS == ref_corpus.EDIT_KINDS
    assert port_corpus.PATCHABLE_KINDS == ref_corpus.PATCHABLE_KINDS


def _fingerprint(pkg):
    prog = _pairs(pkg)["delay"].base()
    fps = pkg.delta.fingerprint_design(prog)
    assert fps.key == pkg.trace.program_fingerprint(prog)
    assert fps.module_names == tuple(m.name for m in prog.modules)
    return {"program": fps.program, "fifo_rows": fps.fifo_rows,
            "module_names": fps.module_names}


def test_fingerprint_key_matches_program_fingerprint():
    _both(_fingerprint)


def test_body_hash_is_blind_to_fifo_names_and_depths():
    """``module_content_hash(fifo_depth="blind")`` hashes a captured FIFO
    as a placeholder: the rename pair's modules keep their body hash."""
    p = _pairs(PORT)["rename"]
    old = port_delta.fingerprint_design(p.base())
    new = port_delta.fingerprint_design(p.edited())
    changed = [(o, n) for o, n in zip(old.modules, new.modules)
               if o.sig != n.sig]
    assert changed
    assert all(o.body == n.body for o, n in changed)
    fn = p.base().modules[0].fn
    hashes = {port_trace.module_content_hash(fn, fifo_depth=f)
              for f in (True, False, "blind")}
    assert len(hashes) == 3


def _diff_identical(pkg):
    p = _pairs(pkg)["delay"]
    fd = pkg.delta.fingerprint_design
    d = pkg.delta.diff(fd(p.base()), fd(p.base()))
    assert d.identical and d.patchable and not d.edited
    assert all(lbl == pkg.delta.UNCHANGED for lbl in d.modules.values())
    return _delta_seen(d)


def test_diff_identical_builders():
    _both(_diff_identical)


def _diff_body_edit(pkg):
    p = _pairs(pkg)["delay"]
    fd = pkg.delta.fingerprint_design
    d = pkg.delta.diff(fd(p.base()), fd(p.edited()))
    assert d.patchable and not d.identical
    assert pkg.delta.BODY_EDITED in d.modules.values()
    # a pure timing edit touches exactly the edited module
    assert sum(1 for v in d.modules.values()
               if v != pkg.delta.UNCHANGED) == 1
    return _delta_seen(d)


def test_diff_classifies_body_edit():
    _both(_diff_body_edit)


def _diff_retype_and_rename(pkg):
    fd, diff = pkg.delta.fingerprint_design, pkg.delta.diff
    base = fd(_pairs(pkg)["retype"].base())
    d = diff(base, fd(_pairs(pkg)["retype"].edited()))
    assert d.patchable and pkg.delta.RETYPED in [lbl for _, lbl in d.fifos]
    assert all(lbl == pkg.delta.UNCHANGED for lbl in d.modules.values())
    d2 = diff(base, fd(_pairs(pkg)["rename"].edited()))
    assert not d2.patchable and pkg.delta.RENAMED in [lbl for _, lbl
                                                      in d2.fifos]
    assert "renam" in d2.reason
    return _delta_seen(d), _delta_seen(d2)


def test_diff_classifies_retype_and_rename():
    _both(_diff_retype_and_rename)


def _diff_topology(pkg):
    seen = {}
    fd = pkg.delta.fingerprint_design
    for kind in ("interface", "added", "removed"):
        p = _pairs(pkg)[kind]
        d = pkg.delta.diff(fd(p.base()), fd(p.edited()))
        assert not d.patchable, kind
        assert d.reason, kind
        seen[kind] = _delta_seen(d)
    return seen


def test_diff_rejects_topology_changes():
    _both(_diff_topology)


def _diff_kind(pkg, kind):
    p = _pairs(pkg)[kind]
    fd = pkg.delta.fingerprint_design
    return _delta_seen(pkg.delta.diff(fd(p.base()), fd(p.edited())))


@pytest.mark.parametrize("kind", port_corpus.EDIT_KINDS)
def test_diff_equals_the_reference_module_by_module(kind):
    _both(_diff_kind, kind)


# ------------------------------------------------------- differential patch
def _patch(pkg, kind):
    """Every edit class: a patched result equals the cold run bit-for-bit
    (cycles, outputs, FIFO digests, stats); a reject falls back to cold."""
    p = _pairs(pkg)[kind]
    record = pkg.corpus.result_record
    _, state = pkg.delta.snapshot(p.base())
    cold, _ = pkg.delta.snapshot(p.edited())
    out = pkg.delta.apply_patch(state, p.edited())
    if p.expect == "patched":
        assert out.ok, (kind, out.reason)
        assert record(out.result) == record(cold)
        assert out.reused_modules >= out.total_modules - 1
    else:
        assert not out.ok and out.reason, kind
    served = out.result if out.ok else cold
    assert record(served) == record(cold)
    assert record(cold) == record(pkg.core.simulate(p.edited()))
    return {"ok": out.ok, "mode": out.mode, "reason": out.reason,
            "reused": out.reused_modules, "edited": out.edited_modules,
            "total": out.total_modules, "served": record(served),
            "engine": served.engine}


@pytest.mark.parametrize("kind", port_corpus.EDIT_KINDS)
def test_patch_bit_identical_or_rejects(kind):
    _both(_patch, kind)


def _patch_chain(pkg):
    """delay applied, then edited back, on top of a patched snapshot: each
    hop verifies against its own cold run."""
    d = _pairs(pkg)["delay"]
    record = pkg.corpus.result_record
    _, state = pkg.delta.snapshot(d.base())
    out1 = pkg.delta.apply_patch(state, d.edited())
    assert out1.ok
    out2 = pkg.delta.apply_patch(out1.state, d.base())     # edit it *back*
    assert out2.ok, out2.reason
    cold, _ = pkg.delta.snapshot(d.base())
    assert record(out2.result) == record(cold)
    return [(o.mode, o.reused_modules, record(o.result))
            for o in (out1, out2)]


def test_patch_chains_from_patched_state():
    _both(_patch_chain)


def _value_reject(pkg):
    p = _pairs(pkg)["value"]
    _, state = pkg.delta.snapshot(p.base())
    out = pkg.delta.apply_patch(state, p.edited())
    assert not out.ok and "write stream" in out.reason
    return out.reason


def test_value_edit_reject_reason_names_the_stream():
    _both(_value_reject)


def _cold_build_dynamic(pkg):
    """``cold_build`` of a dynamic design: no state, the shared
    ``HybridCache`` learns the run."""
    hc = pkg.trace.HybridCache()
    res, state = pkg.delta.cold_build(_poll_design(pkg, "poll_cold"),
                                      hybrid_cache=hc)
    assert state is None and res.engine == "omnisim-hybrid"
    return (pkg.corpus.result_record(res), hc.misses, hc.hits,
            hc.full_misses)


def test_cold_build_of_a_dynamic_design_has_no_state():
    _both(_cold_build_dynamic)


# --------------------------------------------------------- delta-aware cache
def _cache_tiers(pkg):
    p = _pairs(pkg)["delay"]
    cache = pkg.sweep.GraphCache(capacity=4)
    fd = pkg.delta.fingerprint_design
    fps0 = fd(p.base())
    look0 = cache.get_or_patch(p.base(), fps0, None)
    assert look0.mode == "cold" and look0.state is not None
    # tier 2: patch from the held state
    fps1 = fd(p.edited())
    look1 = cache.get_or_patch(p.edited(), fps1, look0.state)
    assert look1.mode == "patched"
    assert look1.entry.key == fps1.key != fps0.key
    # tier 1: the patched entry now answers the exact key
    look2 = cache.get_or_patch(p.edited(), fps1, None)
    assert look2.mode == "exact" and look2.entry is look1.entry
    assert look2.state is None
    st = cache.stats()
    assert st["delta_hits"] == 1 and st["delta_rejects"] == 0
    return ([(lk.mode, lk.reason, lk.reused_modules, lk.total_modules,
              pkg.corpus.result_record(lk.entry.result))
             for lk in (look0, look1, look2)], _cache_stats(cache))


def test_cache_get_or_patch_tiers():
    _both(_cache_tiers)


def _cache_reject(pkg):
    p = _pairs(pkg)["value"]
    cache = pkg.sweep.GraphCache(capacity=4)
    fd = pkg.delta.fingerprint_design
    look0 = cache.get_or_patch(p.base(), fd(p.base()), None)
    look1 = cache.get_or_patch(p.edited(), fd(p.edited()), look0.state)
    assert look1.mode == "cold" and look1.reason
    assert cache.stats()["delta_rejects"] == 1
    ref = pkg.core.simulate(p.edited())
    record = pkg.corpus.result_record
    assert record(look1.entry.result) == record(ref)
    return look1.mode, look1.reason, record(ref), _cache_stats(cache)


def test_cache_reject_falls_back_cold():
    _both(_cache_reject)


def test_delta_lookup_is_the_reference_named_tuple():
    assert port_cache.DeltaLookup._fields == ref_sweep.cache.DeltaLookup._fields
    look = port_cache.DeltaLookup(None, "cold", "", None, 0, 3)
    assert look.mode == "cold" and look.total_modules == 3


# ------------------------------------------------------------- edit sessions
def _session_patched(pkg):
    p = _pairs(pkg)["delay"]
    D = _depth_block(p.base())
    with _service(pkg, block=4) as svc:
        sess = svc.edit_session(p.base())
        sess.sweep(D)                       # warm the base entry
        out = sess.update(p.edited())
        assert out.mode == "patched" and out.reuse_fraction >= 0.9
        served = sess.sweep(D)
        stats = _cache_stats(svc.cache)
    with _service(pkg, block=4) as svc2:
        ref = svc2.sweep(p.edited(), D)
    assert (served.status == ref.status).all()
    assert (served.cycles == ref.cycles).all()
    for k in range(len(D)):
        if ref.results[k] is not None:
            assert served.results[k].outputs == ref.results[k].outputs
    return (out.mode, out.reused_modules, out.total_modules, _seen(served),
            stats)


@pytest.mark.parametrize("lane", PORT_LANES)
def test_edit_session_serves_patched_design(lane):
    _both(_session_patched, lane=lane)


def _session_modes(pkg):
    pd, pv = _pairs(pkg)["delay"], _pairs(pkg)["value"]
    seen = []
    with _service(pkg, block=4) as svc:
        sess = svc.edit_session(pd.base())
        assert sess.update(pd.base()).mode == "unchanged"
        assert sess.update(pd.edited()).mode == "patched"
        out = sess.update(pv.edited())      # value edit vs delay-edited state
        assert out.mode == "cold" and out.reason
        seen.append((out.mode, out.reason, out.reused_modules))
        # back to a design the cache already holds: exact-key reuse
        out = sess.update(pd.edited())
        assert out.mode == "exact"
        seen.append((out.mode, out.reason, out.reused_modules))
        st = sess.stats()
        assert st["unchanged"] == 1 and st["patched"] == 1
        assert st["cold"] == 1 and st["rejected"] == 1 and st["exact"] == 1
        cst = svc.stats()["cache"]
        assert cst["delta_hits"] >= 1 and cst["delta_rejects"] >= 1
        st.pop("key")
        return seen, st, _cache_stats(svc.cache)


@pytest.mark.parametrize("lane", PORT_LANES)
def test_edit_session_modes_and_counts(lane):
    _both(_session_modes, lane=lane)


def _session_dynamic(pkg):
    """NB polling designs have no recorded snapshot: every edit rebuilds
    cold, but exact-key reuse still works and nothing crashes."""
    record = pkg.corpus.result_record
    with _service(pkg, block=4) as svc:
        sess = svc.edit_session(_poll_design(pkg, "poll_edit"))
        assert sess.state is None
        out = sess.update(_poll_design(pkg, "poll_edit", d=20))
        assert out.mode == "cold"
        ref = pkg.core.simulate(_poll_design(pkg, "poll_edit", d=20))
        assert record(sess.entry.result) == record(ref)
        again = sess.update(_poll_design(pkg, "poll_edit", d=10))
        assert again.mode == "exact"
        return (out.mode, out.reason, again.mode, record(ref),
                _cache_stats(svc.cache))


@pytest.mark.parametrize("lane", PORT_LANES)
def test_edit_session_dynamic_design_goes_cold(lane):
    _both(_session_dynamic, lane=lane)


def _session_closed(pkg):
    svc = _service(pkg)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.edit_session(_pairs(pkg)["delay"].base())
    with _service(pkg) as svc:
        prog = _pairs(pkg)["delay"].base()
        with pytest.raises(ValueError, match="fingerprint"):
            svc.edit_session(prog, key="not-the-key")
    return True


def test_edit_session_refuses_a_closed_service_and_a_wrong_key():
    _both(_session_closed)


# ---------------------------------------------- scheduler cross-block memo
def _memo_repeat(pkg):
    p = _pairs(pkg)["delay"]
    D = _depth_block(p.base(), rows=3)
    with _service(pkg, block=2) as svc:
        a = svc.sweep(p.base(), D)
        assert svc.stats()["scheduler"]["memo_hits"] == 0
        b = svc.sweep(p.base(), D)
        assert svc.stats()["scheduler"]["memo_hits"] == len(D)
        assert (a.status == b.status).all() and (a.cycles == b.cycles).all()
        assert svc.stats()["scheduler"]["memo_size"] >= len(D)
        return _seen(a), _seen(b), svc.stats()["scheduler"]["memo_size"]


@pytest.mark.parametrize("lane", PORT_LANES)
def test_scheduler_memoizes_repeat_configs(lane):
    _both(_memo_repeat, lane=lane)


def _memo_disabled(pkg):
    p = _pairs(pkg)["delay"]
    D = _depth_block(p.base(), rows=3)
    with _service(pkg, block=2, memo_capacity=0) as svc:
        svc.sweep(p.base(), D)
        b = svc.sweep(p.base(), D)
        assert svc.stats()["scheduler"]["memo_hits"] == 0
        return _seen(b)


@pytest.mark.parametrize("lane", PORT_LANES)
def test_scheduler_memo_disabled(lane):
    _both(_memo_disabled, lane=lane)


def _memo_per_design(pkg):
    """Same depth rows against base and edited designs must NOT share
    memo entries — keys are (design key, depth row)."""
    p = _pairs(pkg)["delay"]
    D = _depth_block(p.base(), rows=2)
    with _service(pkg, block=2) as svc:
        a = svc.sweep(p.base(), D)
        b = svc.sweep(p.edited(), D)
        assert svc.stats()["scheduler"]["memo_hits"] == 0
    ra = pkg.core.simulate(p.base(), depths=list(map(int, D[0])))
    rb = pkg.core.simulate(p.edited(), depths=list(map(int, D[0])))
    assert a.cycles[0] == ra.cycles and b.cycles[0] == rb.cycles
    return _seen(a), _seen(b)


@pytest.mark.parametrize("lane", PORT_LANES)
def test_scheduler_memo_is_per_design_content(lane):
    _both(_memo_per_design, lane=lane)


# ------------------------------------------------------------ full-run spill
def _spill(pkg):
    cache = pkg.sweep.GraphCache(capacity=2)
    entry = cache.get_or_build(_poll_design(pkg, "poll_spill", value=7))
    assert entry.result.engine == "omnisim-hybrid"
    assert entry.full_run is not None
    assert cache.stats()["full_runs"] == 1
    # a hit reinstalls the spilled run into the shared HybridCache
    cache.hybrid._full.clear()
    assert cache.lookup(entry.key) is entry
    assert cache.hybrid.peek_full(entry.key) is entry.full_run
    return _cache_stats(cache)


def test_cache_spills_full_run_for_dynamic_designs():
    _both(_spill)


def _no_spill(pkg):
    cache = pkg.sweep.GraphCache(capacity=2)
    entry = cache.get_or_build(_pairs(pkg)["delay"].base())
    assert entry.full_run is None
    return entry.result.engine, _cache_stats(cache)


def test_traced_designs_have_no_full_run():
    _both(_no_spill)


# ------------------------------------------------------------- big tier
@pytest.mark.delta
@pytest.mark.parametrize("kind", port_corpus.EDIT_KINDS)
def test_delta_differential_300(kind):
    """300-module designs: every edit class, served answer bit-identical
    to cold and to the reference's; patchable classes must reuse >= 90%
    of modules."""
    seen = {}
    for pkg in (_port(), REF):
        p = {q.kind: q for q in pkg.corpus.edit_pairs(11, scale=300)}[kind]
        _, state = pkg.delta.snapshot(p.base())
        t0 = time.perf_counter()
        cold, _ = pkg.delta.snapshot(p.edited())
        t_cold = time.perf_counter() - t0
        out = pkg.delta.apply_patch(state, p.edited())
        if kind in pkg.corpus.PATCHABLE_KINDS:
            assert out.ok, out.reason
            assert out.reuse_fraction >= 0.9
            assert out.elapsed_s < max(t_cold, 1e-3) * 5
        else:
            assert not out.ok
        served = out.result if out.ok else cold
        record = pkg.corpus.result_record
        assert record(served) == record(cold)
        seen[pkg is REF] = (out.ok, out.mode, out.reason,
                            out.reused_modules, record(served))
    assert seen[False] == seen[True]
