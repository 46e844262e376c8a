"""PyTorch port, ninth slice: the design corpus and its conformance runner
(``repro_torch.corpus``) against the reference's (``repro.corpus``).

Every tier-1 case of the reference's ``tests/test_corpus.py`` runs here on
the port, and each also runs the reference on the same ``(seed, scale,
spec)`` and requires the same answer:

  * corpus plans (``case._plan.fifo_rows``, ``case._plan.modules``,
    ``case.meta``) are plain tuples and dicts, equal between the packages;
  * ``check_conformance(device="cpu")`` passes every engine path, and each
    path's verdict equals the reference report's at the same position (the
    port's ``"cuda"`` path, the sparse max-plus kernel's lane, against the
    reference's ``"jax"`` Pallas lane);
  * the generator-engine ``result_record`` (``fifo_digest`` included)
    equals the reference's, and the checked-in seed list
    ``tests/golden/corpus_seeds.json`` (read, never rewritten here).

``program_fingerprint`` hashes each package's own bytecode, so keys are
compared only within a package.  The big tiers keep the reference's
markers (``-m corpus``, ``-m rtl``) and stay out of tier-1.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.corpus as ref_corpus
from repro.core import simulate as ref_simulate
from repro_torch import corpus
from repro_torch.core import simulate
from repro_torch.core.taxonomy import classify_dynamic
from repro_torch.core.trace import program_fingerprint
from repro_torch.corpus import (BENCH_SPEC, BLOCKING_SPEC, DEFAULT_SPEC,
                                check_conformance, fifo_digest, generate,
                                result_record, rtl_crosscheck)
from repro_torch.sweep import SweepService

SEEDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "corpus_seeds.json")

#: the checked-in seed list: every (seed, scale) pinned in corpus_seeds.json
PINNED = [(seed, scale) for scale in (10, 32) for seed in range(8)]

_SPECS = {"default": (DEFAULT_SPEC, ref_corpus.DEFAULT_SPEC),
          "blocking": (BLOCKING_SPEC, ref_corpus.BLOCKING_SPEC),
          "bench": (BENCH_SPEC, ref_corpus.BENCH_SPEC)}


def _same_plan(case, ref_case):
    assert case.name == ref_case.name
    assert case.meta == ref_case.meta
    assert case._plan.fifo_rows == ref_case._plan.fifo_rows
    assert case._plan.modules == ref_case._plan.modules


def _conform(seed, scale, spec=None, ref_spec=None):
    """The port's report (``device="cpu"``) after checking it against the
    reference's on the same design, path by path."""
    kw, ref_kw = ({}, {}) if spec is None else ({"spec": spec},
                                                {"spec": ref_spec})
    c = generate(seed, scale=scale, **kw)
    r = ref_corpus.generate(seed, scale=scale, **ref_kw)
    _same_plan(c, r)
    rep = check_conformance(c.builder, name=c.name, device="cpu")
    ref_rep = ref_corpus.check_conformance(r.builder, name=r.name)
    assert rep.ok and ref_rep.ok
    ours = [("jax" if p == "cuda" else p, v) for p, v in rep.paths.items()]
    assert ours == list(ref_rep.paths.items()), c.name
    assert rep.reference == ref_rep.reference, c.name
    assert (rep.deadlock, rep.hybrid_supported) == (ref_rep.deadlock,
                                                    ref_rep.hybrid_supported)
    # every path ran, or was skipped exactly where the reference skips it
    assert all(v == "ok" or v.startswith("skipped")
               for v in rep.paths.values())
    if not rep.deadlock:
        assert rep.paths["cuda"] == rep.paths["sweep"] == "ok"
    return rep


# ---------------------------------------------------------------------------
# generator: determinism + structure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,scale", [(0, 10), (3, 32), (1, 100)])
def test_regenerate_is_bit_identical(seed, scale):
    a = generate(seed, scale=scale)
    b = generate(seed, scale=scale)
    assert a.meta == b.meta
    assert program_fingerprint(a.builder()) == program_fingerprint(
        b.builder())
    ra, rb = simulate(a.builder()), simulate(b.builder())
    assert ra.cycles == rb.cycles
    assert fifo_digest(ra) == fifo_digest(rb)
    # the same plan, and the same simulated artifacts, as the reference's
    r = ref_corpus.generate(seed, scale=scale)
    _same_plan(a, r)
    rr = ref_simulate(r.builder())
    assert (ra.engine, ra.cycles) == (rr.engine, rr.cycles)
    assert result_record(ra) == ref_corpus.result_record(rr)


@pytest.mark.parametrize("scale", [10, 32, 100])
def test_scale_knob_tracks_module_count(scale):
    for seed in range(4):
        c = generate(seed, scale=scale)
        assert scale <= c.meta["modules"] <= scale + 16
        assert c.meta["modules"] == len(c.builder().modules)
        assert c.meta == ref_corpus.generate(seed, scale=scale).meta


@pytest.mark.parametrize("spec", list(_SPECS), ids=list(_SPECS))
def test_structural_invariants(spec):
    spec, ref_spec = _SPECS[spec]
    for seed in range(4):
        c = generate(seed, scale=24, spec=spec)
        c.validate()                     # SPSC + full connectivity
        assert len(c.meta["clusters"]) >= 1
        assert c.meta["fifos"] == len(c.builder().fifos)
        _same_plan(c, ref_corpus.generate(seed, scale=24, spec=ref_spec))


def test_validate_rejects_a_fifo_without_a_reader():
    c = generate(0, scale=10)
    c._plan.fifo_rows.append(("orphan", 1))
    with pytest.raises(AssertionError, match="orphan"):
        c.validate()


def test_different_seeds_differ():
    fps = {program_fingerprint(generate(s, scale=24).builder())
           for s in range(6)}
    assert len(fps) == 6


def test_declared_taxonomy_matches_dynamic_classification():
    for seed in range(6):
        c = generate(seed, scale=24)
        cls = classify_dynamic(c.builder)
        assert cls.dtype == c.meta["declared"], (
            f"{c.name}: declared {c.meta['declared']} but classified "
            f"{cls.dtype}")
        assert cls.has_nonblocking == c.meta["has_nb"]


def test_blocking_spec_has_no_nb():
    for seed in range(4):
        c = generate(seed, scale=24, spec=BLOCKING_SPEC)
        assert not c.meta["has_nb"]
        assert c.meta["declared"] in ("A", "B")


def test_spec_is_plain_data():
    with pytest.raises(ValueError, match="empty IntRange"):
        corpus.IntRange(3, 2)
    spec = BLOCKING_SPEC.replace(items=corpus.IntRange(48, 96))
    assert spec.items == corpus.IntRange(48, 96)
    assert spec.motif_weights == BLOCKING_SPEC.motif_weights
    for name in ("DEFAULT_SPEC", "BLOCKING_SPEC", "BENCH_SPEC"):
        ours, ref = getattr(corpus, name), getattr(ref_corpus, name)
        assert repr(ours) == repr(ref)


# ---------------------------------------------------------------------------
# the fuzz builders (the reference's tests/fuzz_designs.py re-exports them)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build", ["build_case", "build_poll_case"])
@pytest.mark.parametrize("seed", range(0, 48, 3))
def test_fuzz_builders_match_the_reference(build, seed):
    builder, meta = getattr(corpus, build)(seed)
    ref_builder, ref_meta = getattr(ref_corpus, build)(seed)
    assert meta == ref_meta
    for trace in ("never", "auto"):
        got = simulate(builder(), trace=trace)
        want = ref_simulate(ref_builder(), trace=trace)
        assert got.engine == want.engine
        assert result_record(got) == ref_corpus.result_record(want)


# ---------------------------------------------------------------------------
# conformance: fast tier-1 slice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(8))
def test_conformance_small(seed):
    for scale in (10, 32):
        _conform(seed, scale)


def test_conformance_blocking_spec():
    for seed in range(4):
        _conform(seed, 24, BLOCKING_SPEC, ref_corpus.BLOCKING_SPEC)


def test_starved_designs_deadlock_conformantly():
    spec = DEFAULT_SPEC.replace(starve_prob=0.5)
    ref_spec = ref_corpus.DEFAULT_SPEC.replace(starve_prob=0.5)
    deadlocks = 0
    for seed in range(8):
        rep = _conform(seed, 24, spec, ref_spec)
        deadlocks += rep.deadlock
    assert deadlocks >= 1          # the knob actually produces deadlocks
    assert deadlocks < 8           # ... but not unconditionally


def test_conformance_paths_and_mismatch_reporting():
    assert corpus.ENGINE_PATHS[:-1] == ref_corpus.ENGINE_PATHS[:-1]
    assert (corpus.ENGINE_PATHS[-1], ref_corpus.ENGINE_PATHS[-1]) == (
        "cuda", "jax")
    c = generate(1, scale=10)
    rep = check_conformance(c.builder, name=c.name, device="cpu",
                            paths=("generator", "cuda"))
    assert list(rep.paths) == ["generator", "cuda"]
    rep.paths["cuda"] = "MISMATCH: injected"
    assert not rep.ok
    with pytest.raises(AssertionError, match="cuda: MISMATCH: injected"):
        rep.raise_on_mismatch()


def test_conformance_on_the_card_raises_without_one(monkeypatch):
    """``device="cuda"`` (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = generate(1, scale=10)
    for paths in (("generator", "cuda"), ("generator", "sweep")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_conformance(c.builder, paths=paths)


def test_conformance_reuses_a_live_service():
    with SweepService(backend="numpy", autostart=False) as svc:
        for seed in range(2):
            c = generate(seed, scale=10)
            rep = check_conformance(c.builder, name=c.name, service=svc,
                                    device="cpu")
            assert rep.paths["sweep"] in ("ok",
                                          "skipped: base design deadlocks")
        assert svc.stats()["cache"]["misses"] >= 1


def test_rtl_crosscheck_matches_the_reference_on_small_designs():
    for seed in (0, 3):
        c, r = generate(seed, scale=10), ref_corpus.generate(seed, scale=10)
        got = rtl_crosscheck(c.builder)
        assert got["agree"], got
        assert got == ref_corpus.rtl_crosscheck(r.builder)


# ---------------------------------------------------------------------------
# pinned seed list (golden): read, never rewritten by this file
# ---------------------------------------------------------------------------
def _seed_record(seed, scale):
    c = generate(seed, scale=scale)
    g = simulate(c.builder(), trace="never")
    return {
        "seed": seed, "scale": scale,
        "modules": c.meta["modules"], "fifos": c.meta["fifos"],
        "declared": c.meta["declared"],
        "cycles": int(g.cycles), "deadlock": bool(g.deadlock),
        "fifo_digest": fifo_digest(g),
    }


@pytest.mark.golden
def test_corpus_seed_list():
    with open(SEEDS_PATH) as f:
        want = json.load(f)
    assert [_seed_record(seed, scale) for seed, scale in PINNED] == want


# ---------------------------------------------------------------------------
# scale acceptance: a 300-module design end-to-end (tier-1)
# ---------------------------------------------------------------------------
def test_300_module_design_end_to_end():
    c = generate(2, scale=300)
    assert c.meta["modules"] >= 300
    g = simulate(c.builder(), trace="auto")
    assert not g.deadlock
    assert g.cycles > 0

    dv = tuple(int(d) + 1 for d in g.depths)
    D = np.asarray([dv, [int(d) for d in g.depths]], dtype=np.int64)
    svc = SweepService(device="cpu", block=16, shards=2, autostart=False)
    try:
        s = svc.sweep(g, D)
        assert int(s.cycles[1]) == int(g.cycles)
        assert not s.results[1].deadlock
    finally:
        svc.close()
    # the reference's design, engine and served rows are the same
    r = ref_corpus.generate(2, scale=300)
    _same_plan(c, r)
    rg = ref_simulate(r.builder(), trace="auto")
    assert g.engine == rg.engine
    assert result_record(g) == ref_corpus.result_record(rg)
    from repro.sweep import SweepService as RefSweepService
    with RefSweepService(block=16, shards=2, autostart=False) as ref_svc:
        rs = ref_svc.sweep(rg, D)
    assert s.status.tolist() == rs.status.tolist()
    assert s.cycles.tolist() == rs.cycles.tolist()


# ---------------------------------------------------------------------------
# big tiers: -m corpus (100+-module sweep) and -m rtl (oracle cross-check)
# ---------------------------------------------------------------------------
def pytest_generate_tests(metafunc):
    if "big_seed" in metafunc.fixturenames:
        n = metafunc.config.getoption("--corpus-seeds")
        metafunc.parametrize("big_seed", range(n))


@pytest.mark.corpus
def test_conformance_at_scale(big_seed, corpus_scale):
    rep = _conform(big_seed, corpus_scale)
    assert rep.ok


@pytest.mark.corpus
def test_conformance_1000_modules():
    rep = _conform(0, 1000)
    assert rep.ok
    assert generate(0, scale=1000).meta["modules"] >= 1000


@pytest.mark.rtl
def test_rtl_crosscheck_sampled():
    # >= 10 corpus designs must agree with the cycle-stepped RTL oracle —
    # outputs AND exact cycle counts (deadlock verdicts for dead designs)
    cases = ([(s, 10) for s in range(6)] + [(s, 32) for s in range(6)]
             + [(0, 100), (2, 300)])
    for seed, scale in cases:
        c = generate(seed, scale=scale)
        r = rtl_crosscheck(c.builder)
        assert r["agree"], f"{c.name}: engine vs RTL oracle disagree: {r}"


@pytest.mark.rtl
def test_rtl_crosscheck_starved():
    spec = DEFAULT_SPEC.replace(starve_prob=0.5)
    seen_deadlock = False
    for seed in range(4):
        c = generate(seed, scale=16, spec=spec)
        r = rtl_crosscheck(c.builder)
        assert r["agree"], f"{c.name}: {r}"
        seen_deadlock = seen_deadlock or r["deadlock"]
    assert seen_deadlock
