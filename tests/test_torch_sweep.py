"""PyTorch port, sweep service (``repro_torch.sweep``) against the
reference's (``repro.sweep``).

Each scenario is written once, as a function of a package (``REF``: the
reference's ``sweep``, ``core`` and ``designs``; ``PORT``: the port's) and
of a solver lane, and returns what a client observes: every delivered
row's status, cycles, violated count, ok flag and reason string, the
fallback results' cycles, outputs and deadlock flag, and, in manual mode
(``autostart=False``, ``step()``), the scheduler's, admission's,
quarantine's and fault injector's stats.  The port runs on
``backend="cuda", device="cpu"`` (the kernels' plain PyTorch versions) and
on ``backend="numpy"``; the reference on ``backend="numpy"``, and once on
``backend="jax"`` in Pallas interpret mode.  Observations must be equal,
bit for bit.  Design keys differ between the packages (they hash
bytecode), so no observation includes one.
"""
import pickle
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.designs.paper as ref_paper
import repro.designs.typea as ref_typea
import repro.sweep as ref_sweep
import repro_torch.core as port_core
import repro_torch.core.dse as port_dse
import repro_torch.designs.paper as port_paper
import repro_torch.designs.typea as port_typea
import repro_torch.sweep as port_sweep
from repro_torch.kernels import _cuda
from repro_torch.sweep import cache as port_cache
from repro_torch.sweep.search import _feasible_mask
from test_torch_hybrid import _counters

REF = SimpleNamespace(core=ref_core, sweep=ref_sweep, typea=ref_typea,
                      paper=ref_paper)
PORT = SimpleNamespace(core=port_core, sweep=port_sweep, typea=port_typea,
                       paper=port_paper)
REF_LANE = {"backend": "numpy"}
PORT_LANES = [
    pytest.param({"backend": "cuda", "device": "cpu"}, id="cuda-cpu"),
    pytest.param({"backend": "numpy"}, id="numpy")]

_REF_SEEN = {}


def _ref(scenario, *args):
    """The reference's observation of ``scenario`` (once per arguments)."""
    key = (scenario.__name__,) + args
    if key not in _REF_SEEN:
        _REF_SEEN[key] = scenario(REF, REF_LANE, *args)
    return _REF_SEEN[key]


def _service(pkg, lane, **kw):
    kw.setdefault("autostart", False)
    return pkg.sweep.SweepService(**lane, **kw)


def _seen(out):
    """What a client reads from a BatchOutcome (results by content)."""
    return {
        "status": out.status.tolist(), "cycles": out.cycles.tolist(),
        "violated": out.violated.tolist(), "ok": out.ok.tolist(),
        "reasons": list(out.reasons), "n_unique": out.n_unique,
        "results": [None if r is None else (r.cycles, r.outputs, r.deadlock)
                    for r in out.results]}


def _stats(svc):
    """The service's stats (they hold no design key)."""
    st = svc.stats()
    st["cache"] = {k: st["cache"][k] for k in ("size", "hits", "misses",
                                               "evictions", "full_runs")}
    return st


def _drain(svc):
    while svc.step():
        pass


# ----------------------------------------------------------- conformance
def mixed_statuses(pkg, lane):
    """fig4_ex5 mixes reuse, constraint flips and fallback re-sims."""
    base = pkg.core.simulate(pkg.paper.fig4_ex5())
    D = np.array([(2, 100), (100, 2), (2, 2), (1, 1), (64, 64), (2, 100)])
    with _service(pkg, lane, block=2, shards=2) as svc:
        out = svc.sweep(pkg.paper.fig4_ex5(), D)
    direct = pkg.core.resimulate_batch(base, D, backend="numpy")
    assert _seen(out)["cycles"] == _seen(direct)["cycles"]
    return _seen(out), _stats(svc)


def repeated_fallback(pkg, lane):
    """fig4_ex5's violated rows fall back to the hybrid replay with the
    service's shared HybridCache: a repeat sweep replays the verified
    whole runs its first fallbacks stored, the cold build's run spills
    onto the cache entry, and a cache hit reinstalls it."""
    build = lambda: pkg.paper.fig4_ex5(n=256)
    D = np.array([(1, 1), (2, 2), (64, 64), (2, 100), (1, 3)])
    seen = []
    with _service(pkg, lane, block=8) as svc:
        assert svc.scheduler.hybrid is svc.cache.hybrid
        for _ in range(2):
            seen += [_seen(svc.sweep(build(), D)),
                     _counters(svc.cache.hybrid)]
        (entry,) = svc.cache._entries.values()
        assert entry.result.engine == "omnisim-hybrid"
        assert entry.full_run is not None
        assert svc.stats()["cache"]["full_runs"] == 1
        fallbacks = svc.stats()["scheduler"]["fallbacks"]
        assert seen[3]["full_hits"] - seen[1]["full_hits"] == fallbacks // 2
        svc.cache.hybrid._full.clear()
        seen.append(_seen(svc.sweep(build(), D)))
        assert svc.cache.hybrid.peek_full(entry.key) is entry.full_run
        seen.append(_counters(svc.cache.hybrid))
    return seen, _stats(svc)


def deadlock_rows(pkg, lane):
    build = lambda: pkg.typea.producer_consumer(n=32, depth=4)
    with _service(pkg, lane, block=1) as svc:
        out = svc.sweep(build(), np.array([[8], [1], [2]]))
    return _seen(out), _stats(svc)


def block_split(pkg, lane, block, shards, mode):
    """Any block split, shard count and mode; then the warm cache with
    the rows in reversed arrival order.  skynet_like at this size gives
    every row the same cycles; merge_sort_staged(4) spreads them."""
    build = lambda: pkg.typea.skynet_like(items=48, depth=6)
    rng = np.random.default_rng(7)
    D = rng.integers(1, 13, size=(24, len(build().fifos)))
    Dm = rng.integers(1, 5, size=(24, len(pkg.typea.merge_sort_staged(4)
                                          .fifos)))
    seen = []
    with _service(pkg, lane, block=block, shards=shards, mode=mode,
                  min_shard_rows=1) as svc:
        for prog, rows in ((build, D), (lambda: pkg.typea.merge_sort_staged(4),
                                        Dm)):
            seen += [_seen(svc.sweep(prog(), rows)),
                     _seen(svc.sweep(prog(), rows[::-1]))]
    return seen, _stats(svc)


def tenants_with_duplicates(pkg, lane):
    """Two tenants, overlapping and repeated rows, coalesced into shared
    blocks and solved once per unique row."""
    build = lambda: pkg.typea.skynet_like(items=48, depth=6)
    rng = np.random.default_rng(21)
    D1 = rng.integers(2, 9, size=(12, len(build().fifos)))
    D2 = np.concatenate([D1[3:9], D1[:2], D1[:2]])
    with _service(pkg, lane, block=8) as svc:
        h1 = svc.submit(build(), D1, tenant="a", priority="bulk")
        h2 = svc.submit(build(), D2, tenant="b", priority="bulk")
        _drain(svc)
        return _seen(h1.result()), _seen(h2.result()), _stats(svc)


def memo_repeats(pkg, lane):
    """Repeat rows in later blocks are answered from the memo, in any
    order, without a solve."""
    build = lambda: pkg.typea.producer_consumer(n=32, depth=4)
    D = np.array([[1], [2], [3], [4], [6], [8]])
    with _service(pkg, lane, block=4) as svc:
        first = svc.sweep(build(), D)
        again = svc.sweep(build(), D[::-1])
        more = svc.sweep(build(), np.array([[5], [8], [1], [12]]))
        st = _stats(svc)
    assert st["scheduler"]["memo_hits"] == len(D) + 2
    return _seen(first), _seen(again), _seen(more), st


@pytest.mark.parametrize("lane", PORT_LANES)
@pytest.mark.parametrize("scenario", [mixed_statuses, deadlock_rows,
                                      tenants_with_duplicates, memo_repeats,
                                      repeated_fallback],
                         ids=lambda f: f.__name__)
def test_served_rows_match_the_reference(scenario, lane):
    assert scenario(PORT, lane) == _ref(scenario)


@pytest.mark.parametrize("lane", PORT_LANES)
@pytest.mark.parametrize("mode", ["serial", "thread"])
@pytest.mark.parametrize("block,shards", [(1, 1), (5, 3), (64, 1)])
def test_any_block_split_shards_and_order_match_the_reference(
        block, shards, mode, lane):
    assert (block_split(PORT, lane, block, shards, mode)
            == _ref(block_split, block, shards, mode))


def test_cuda_lane_matches_the_reference_pallas_lane():
    """The port's sparse lane (plain version, CPU) against the reference's
    sparse Pallas kernel in interpret mode, served the same way."""
    def serve(pkg, lane):
        build = lambda: pkg.typea.skynet_like(items=32, depth=5)
        D = np.random.default_rng(11).integers(1, 10,
                                               size=(24, len(build().fifos)))
        with _service(pkg, lane, block=8, shards=2) as svc:
            return _seen(svc.sweep(build(), D)), _stats(svc)

    got = serve(PORT, {"backend": "cuda", "device": "cpu"})
    want = serve(REF, {"backend": "jax", "jax_interpret": True})
    assert got == want
    assert want[0]["status"].count(ref_core.dse.REUSED) > 0


# --------------------------------------------------------------- scheduler
def priority_lanes(pkg, lane):
    bulk_b = lambda: pkg.typea.skynet_like(items=48, depth=6)
    inter_b = lambda: pkg.typea.producer_consumer(n=32, depth=2)
    Db = np.full((40, len(bulk_b().fifos)), 8, dtype=np.int64)
    Db += np.arange(40)[:, None] % 5
    with _service(pkg, lane, block=8) as svc:
        hb = svc.submit(bulk_b(), Db, priority="bulk")
        svc.step()
        hi = svc.submit(inter_b(), np.array([[2], [4]]))
        svc.step()
        mid = (hi._req.priority, hi._req.delivered, hb._req.delivered)
        _drain(svc)
        return mid, _seen(hi.result()), _seen(hb.result()), _stats(svc)


def starvation(pkg, lane):
    inter_b = lambda: pkg.typea.producer_consumer(n=32, depth=2)
    bulk_b = lambda: pkg.typea.skynet_like(items=48, depth=6)
    Db = np.full((32, len(bulk_b().fifos)), 8, dtype=np.int64)
    with _service(pkg, lane, block=4, starvation_limit=2) as svc:
        hb = svc.submit(bulk_b(), Db, priority="bulk")
        his = [svc.submit(inter_b(), np.array([[d], [d + 1]]))
               for d in range(1, 7)]
        for _ in range(3):
            svc.step()
        mid = _stats(svc)
        _drain(svc)
        return (mid, [_seen(h.result()) for h in his], _seen(hb.result()),
                _stats(svc))


def starvation_debt_resets(pkg, lane):
    inter_b = lambda: pkg.typea.producer_consumer(n=32, depth=2)
    bulk_b = lambda: pkg.typea.skynet_like(items=48, depth=6)
    with _service(pkg, lane, block=4, starvation_limit=1) as svc:
        for d in (1, 2, 3):
            svc.submit(inter_b(), np.array([[d]]))
            svc.step()
        Db = np.full((16, len(bulk_b().fifos)), 8, dtype=np.int64)
        svc.submit(bulk_b(), Db, priority="bulk")
        hi = svc.submit(inter_b(), np.array([[4]]))
        svc.step()
        mid = hi._req.delivered
        _drain(svc)
        return mid, _seen(hi.result()), _stats(svc)


def coalescing(pkg, lane):
    build = lambda: pkg.typea.producer_consumer(n=32, depth=2)
    with _service(pkg, lane, block=16) as svc:
        h1 = svc.submit(build(), np.array([[1], [2], [4]]), priority="bulk")
        h2 = svc.submit(build(), np.array([[2], [4], [8]]), priority="bulk")
        steps = [svc.step(), svc.step()]
        return steps, _seen(h1.result()), _seen(h2.result()), _stats(svc)


def cancellation(pkg, lane):
    build = lambda: pkg.typea.skynet_like(items=48, depth=6)
    D = np.random.default_rng(0).integers(4, 13,
                                          size=(30, len(build().fifos)))
    Da = np.full((40, len(build().fifos)), 8, dtype=np.int64)
    Da += np.arange(40)[:, None] % 5
    with _service(pkg, lane, block=10) as svc:
        h = svc.submit(build(), D, priority="bulk")
        svc.step()
        h.cancel()
        svc.step()
        out = h.result()
        # a cancelled request buried behind a long bulk queue
        ha = svc.submit(build(), Da, priority="bulk")
        hb = svc.submit(build(), np.full((2, Da.shape[1]), 9),
                        priority="bulk")
        hb.cancel()
        svc.step()
        mid = (hb._req.finalized, ha.done)
        out_b = hb.result()
        _drain(svc)
        return (_seen(out), mid, _seen(out_b), _seen(ha.result()),
                _stats(svc))


def deadlines(pkg, lane):
    build = lambda: pkg.typea.producer_consumer(n=32, depth=4)
    with _service(pkg, lane, block=4) as svc:
        late = svc.submit(build(), np.array([[2], [4]]), deadline_s=0.0)
        ok = svc.submit(build(), np.array([[1], [8]]), deadline_s=60.0)
        t0 = time.perf_counter()
        while time.perf_counter() <= t0:
            pass
        _drain(svc)
        return _seen(late.result()), _seen(ok.result()), _stats(svc)


def admission(pkg, lane):
    base = pkg.core.simulate(pkg.typea.producer_consumer(n=32, depth=4))
    D3 = np.array([[1], [2], [4]])
    with _service(pkg, lane, block=8, max_inflight_rows_per_tenant=4,
                  max_queued_rows=8) as svc:
        h1 = svc.submit(base, D3, tenant="alice")
        h2 = svc.submit(base, D3, tenant="alice")      # over the quota
        h3 = svc.submit(base, D3, tenant="bob")
        h4 = svc.submit(base, D3, tenant="carol")      # load shed
        h5 = svc.submit(base, np.array([[3]]), tenant="dave")
        h5.cancel()
        flags = [h.rejected for h in (h1, h2, h3, h4, h5)]
        mid = svc.admission.inflight("alice")
        _drain(svc)
        outs = [_seen(h.result()) for h in (h1, h2, h3, h4, h5)]
        h6 = svc.submit(base, D3, tenant="alice")      # released
        _drain(svc)
        return flags, mid, outs, _seen(h6.result()), _stats(svc)


def quarantine(pkg, lane):
    base = pkg.core.simulate(pkg.typea.producer_consumer(n=32, depth=4))
    clean = pkg.core.simulate(pkg.typea.producer_consumer(n=16, depth=2))
    inj = pkg.sweep.FaultInjector(seed=4).arm("shard.fault", at=[0])
    with _service(pkg, lane, block=1, injector=inj, quarantine_after=1,
                  retry=pkg.sweep.RetryPolicy(max_attempts=1,
                                              backoff_s=0.0)) as svc:
        hA = svc.submit(base, np.array([[2]]))
        hB = svc.submit(base, np.array([[4]]))
        _drain(svc)
        outs = [_seen(hA.result()), _seen(hB.result())]
        hC = svc.submit(base, np.array([[8]]))
        outs.append((hC.rejected, _seen(hC.result())))
        outs.append(_seen(svc.sweep(clean, np.array([[2]]))))
        svc.quarantine.reset()
        outs.append(_seen(svc.sweep(base, np.array([[2]]))))
        return outs, _stats(svc)


def shard_faults(pkg, lane):
    """A transient fault and a corrupt shard are retried; a shard that
    faults past the budget fails its rows only; an injected broken pool
    is respawned."""
    build = lambda: pkg.typea.producer_consumer(n=32, depth=4)
    D = np.array([[1], [2], [3], [4], [5], [6], [7], [8]])
    Retry = pkg.sweep.RetryPolicy
    runs = []
    for inj, kw in (
            (pkg.sweep.FaultInjector(seed=3).arm("shard.fault", at=[0]),
             {"retry": Retry(max_attempts=3, backoff_s=0.0)}),
            (pkg.sweep.FaultInjector(seed=11).arm("shard.corrupt", at=[0]),
             {"retry": Retry(max_attempts=3, backoff_s=0.0)}),
            (pkg.sweep.FaultInjector(seed=3).arm("shard.fault", at=[0, 2]),
             {"shards": 2, "min_shard_rows": 1,
              "retry": Retry(max_attempts=2, backoff_s=0.0)}),
            (pkg.sweep.FaultInjector(seed=9).arm("pool.broken", at=[0]),
             {"shards": 2, "min_shard_rows": 1}),
            (pkg.sweep.FaultInjector(seed=2).arm("pool.broken", rate=1.0),
             {"shards": 2, "min_shard_rows": 1, "max_pool_respawns": 0})):
        with _service(pkg, lane, block=8, injector=inj, **kw) as svc:
            seen, st = _seen(svc.sweep(build(), D)), _stats(svc)
        if "pool.broken" in st["faults"]["fired"]:
            # a respawn cancels the other shard's task only if its thread
            # has not taken it yet, and a cancelled task is launched again
            # (drawing each site once more): the draw counts depend on
            # thread timing here, in both packages
            del st["faults"]["draws"]
        runs.append((seen, st))
    return runs


def acceptance_under_faults(pkg, lane):
    """Under a seeded injector faulting one bulk tenant's design, every
    row ends in a definite status and the clean tenant's rows are exact."""
    bulk_base = pkg.core.simulate(pkg.typea.skynet_like(items=48, depth=6))
    live_base = pkg.core.simulate(pkg.typea.producer_consumer(n=32,
                                                              depth=4))
    Db = np.random.default_rng(13).integers(1, 13,
                                            size=(20, len(bulk_base.depths)))
    Dl = np.array([[1], [2], [4], [8]])
    inj = pkg.sweep.FaultInjector(seed=5)
    with _service(pkg, lane, block=4, quarantine_after=100, injector=inj,
                  retry=pkg.sweep.RetryPolicy(max_attempts=2,
                                              backoff_s=0.0)) as svc:
        bulk_key = svc.warm(bulk_base).key
        inj.arm("shard.fault", at=[2, 3], key=bulk_key)
        hb = svc.submit(bulk_base, Db, tenant="bulk", priority="bulk")
        hl = svc.submit(live_base, Dl, tenant="live")
        _drain(svc)
        out_b, out_l = hb.result(), hl.result()
    faulted = out_b.status == ref_core.dse.FAULTED
    assert faulted.any() and (out_b.cycles[faulted] == -1).all()
    return _seen(out_b), _seen(out_l), _stats(svc)


@pytest.mark.parametrize("lane", PORT_LANES)
@pytest.mark.parametrize("scenario", [
    priority_lanes, starvation, starvation_debt_resets, coalescing,
    cancellation, deadlines, admission, quarantine, shard_faults,
    acceptance_under_faults], ids=lambda f: f.__name__)
def test_scheduler_stats_match_the_reference(scenario, lane):
    assert scenario(PORT, lane) == _ref(scenario)


def test_process_shards_spawn_and_match_the_reference():
    """mode="process" starts its workers with ``spawn`` (a forked child
    cannot use CUDA once the parent has); rows and the need-blob round
    trip match the reference's serial run."""
    build = lambda: port_typea.skynet_like(items=48, depth=6)
    base = port_core.simulate(build())
    D = np.random.default_rng(7).integers(1, 13, size=(24, len(base.depths)))
    with _service(PORT, {"backend": "cuda", "device": "cpu"}, block=16,
                  shards=2, mode="process", min_shard_rows=1) as svc:
        assert svc.scheduler._pool._mp_context.get_start_method() == "spawn"
        svc.warm(base)
        out = svc.sweep(build(), D)
        st = svc.stats()["scheduler"]
    with _service(REF, REF_LANE, block=16) as ref_svc:
        want = ref_svc.sweep(ref_typea.skynet_like(items=48, depth=6), D)
    assert _seen(out) == _seen(want)
    assert st["blob_reships"] >= 1 and st["retries"] == 0
    assert st["faulted_rows"] == 0 and st["mode"] == "process"


@pytest.mark.service
def test_process_shards_match_serial_shards():
    build = lambda: port_typea.skynet_like(items=48, depth=6)
    D = np.random.default_rng(3).integers(2, 13,
                                          size=(32, len(build().fifos)))
    lane = {"backend": "cuda", "device": "cpu"}
    with _service(PORT, lane, block=16, shards=1) as svc:
        want = svc.sweep(build(), D)
    with _service(PORT, lane, block=16, shards=2, mode="process") as svc:
        got = svc.sweep(build(), D)
    assert _seen(got) == _seen(want)


@pytest.mark.faults
def test_process_pool_killed_worker_respawns_and_recovers():
    """A worker hard-exiting breaks the spawned pool; the scheduler
    respawns it (warm, through the pool initializer) and the sweep still
    delivers the reference's rows."""
    import os

    base = port_core.simulate(port_typea.skynet_like(items=48, depth=6))
    D = np.random.default_rng(3).integers(1, 13, size=(16, len(base.depths)))
    with _service(REF, REF_LANE, block=16) as ref_svc:
        want = ref_svc.sweep(ref_typea.skynet_like(items=48, depth=6), D)
    with _service(PORT, {"backend": "cuda", "device": "cpu"}, block=16,
                  shards=2, mode="process", min_shard_rows=1,
                  shard_timeout_s=60.0) as svc:
        svc.warm(base)
        svc.sweep(base, D[:2])           # the blob registry, for respawns
        svc.scheduler._pool.submit(os._exit, 11)
        got = svc.sweep(base, D)
    assert _seen(got) == _seen(want)
    assert svc.scheduler.stats()["pool_respawns"] >= 1


# ----------------------------------------------------------- construction
def test_service_raises_without_a_card_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sweep.SweepService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sweep.SweepService(backend="cuda_dense", autostart=False)
    # a host lane, or the plain versions on the CPU, need no card
    port_sweep.SweepService(backend="numpy").close()
    port_sweep.SweepService(device="cpu").close()
    with pytest.raises(ValueError, match="unknown backend"):
        port_sweep.SweepService(backend="jax", device="cpu")


def test_service_raises_when_the_kernel_library_does_not_build(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_nvcc():
        raise RuntimeError("nvcc failed for maxplus_sparse.cu")

    monkeypatch.setattr(_cuda.SPARSE, "lib", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        port_sweep.SweepService()
    loaded = []
    monkeypatch.setattr(_cuda.DENSE, "lib", lambda: loaded.append("dense"))
    port_sweep.SweepService(backend="cuda_dense", autostart=False).close()
    assert loaded == ["dense"]


def test_delta_hooks_are_not_ported_yet():
    with _service(PORT, {"backend": "numpy"}) as svc:
        with pytest.raises(NotImplementedError, match="item 8"):
            svc.edit_session(port_typea.producer_consumer(n=8))
        with pytest.raises(NotImplementedError, match="item 8"):
            svc.cache.get_or_patch(None, None, None)
    with pytest.raises(NotImplementedError, match="item 8"):
        port_cache.DeltaLookup()


def test_public_names_and_cache_stats_keys_match_the_reference():
    assert sorted(port_sweep.__all__) == sorted(ref_sweep.__all__)
    assert (set(port_sweep.GraphCache().stats())
            == set(ref_sweep.GraphCache().stats()))
    for name in ("CANCELLED", "FAULTED", "REJECTED", "TIMED_OUT",
                 "INTERACTIVE", "BULK", "DEFAULT_TENANT"):
        assert getattr(port_sweep, name) == getattr(ref_sweep, name)


def test_launch_counts_survive_shard_threads():
    """CudaLib.count is a locked read-modify-write: eight threads with a
    short switch interval lose no count."""
    import sys
    lib = _cuda.CudaLib("count_check", {}, routes=("a",))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            lib.count("a") for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert lib.launches == 40000 and lib.route_launches == {"a": 40000}
    lib.reset_counts()
    assert lib.launches == 0 and lib.route_launches == {"a": 0}


# ------------------------------------------------------------------ cache
def test_cache_hit_miss_eviction_stats():
    """Hits, misses and evictions; ``full_runs`` counts the entries whose
    cold build (default path) left a hybrid whole run, as in the
    reference."""
    def run(pkg):
        calls = []

        def counting_sim(program, **kw):
            calls.append(program.name)
            return pkg.core.simulate(program, **kw)

        cache = pkg.sweep.GraphCache(capacity=1)
        e1 = cache.get_or_build(pkg.typea.producer_consumer(n=32, depth=2),
                                simulate_fn=counting_sim)
        e1b = cache.get_or_build(pkg.typea.producer_consumer(n=32, depth=2),
                                 simulate_fn=counting_sim)
        assert e1 is e1b and len(calls) == 1 and e1.build_s > 0
        cache.get_or_build(pkg.typea.skynet_like(items=24, depth=4),
                           simulate_fn=counting_sim)
        st = cache.stats()
        assert st["evictions"] == 1 and st["size"] == 1
        cache.get_or_build(pkg.typea.producer_consumer(n=32, depth=2),
                           simulate_fn=counting_sim)
        assert len(calls) == 3
        st = cache.stats()
        assert st["hits"] == 1 and st["misses"] == 3
        assert st["hit_rate"] == pytest.approx(0.25)
        assert st["full_runs"] == st["delta_hits"] == st["delta_rejects"] == 0
        # the default path threads the shared HybridCache: a dynamic
        # design's entry carries its whole run
        cache.get_or_build(pkg.paper.fig4_ex5(n=64))
        seen = [st, cache.stats(), _counters(cache.hybrid)]
        assert seen[1]["full_runs"] == 1
        return seen

    assert run(PORT) == run(REF)
    with pytest.raises(ValueError):
        port_sweep.GraphCache(capacity=0)


def test_cache_accepts_existing_base_result():
    """A base result only hoists the graph; ``full_run`` is what the shared
    HybridCache holds under the design's key, as in the reference."""
    def run(pkg):
        base = pkg.core.simulate(pkg.typea.producer_consumer(n=32, depth=2))
        entry = pkg.sweep.GraphCache().get_or_build(base)
        assert entry.result is base
        assert entry.graph is pkg.core.compile_graph(base.graph)
        assert entry.full_run is None
        hybrid = pkg.core.HybridCache()
        dyn = pkg.core.simulate(pkg.paper.fig4_ex5(n=64),
                                hybrid_cache=hybrid)
        bare = pkg.sweep.GraphCache().get_or_build(dyn)
        shared = pkg.sweep.GraphCache(hybrid=hybrid).get_or_build(dyn)
        assert bare.full_run is None and shared.full_run is not None
        return (dyn.engine, shared.full_run.n_rows,
                _counters(hybrid))

    assert run(PORT) == run(REF)


def test_graph_blob_ships_the_graph_without_its_views():
    base = port_core.simulate(port_typea.producer_consumer(n=32, depth=2))
    entry = port_sweep.GraphCache().get_or_build(base)
    batch_view = entry.batch
    port_core.solve_block_status(entry.graph, np.array([[2], [4]]),
                                 backend="cuda", device="cpu")
    g2 = pickle.loads(entry.graph_blob())
    assert entry.graph.batch is batch_view and batch_view.on_device
    assert g2.batch is None and g2.n == entry.graph.n


# --------------------------------------------------------------- pickling
def test_batch_view_pickles_without_device_tensors():
    """A view that has solved on a device keeps its device tensors in its
    process: the pickle leaves them out, and the restored view solves the
    same rows."""
    base = port_core.simulate(port_typea.skynet_like(items=48, depth=6))
    graph = port_core.compile_graph(base.graph)
    D = np.random.default_rng(5).integers(2, 13, size=(8, len(base.depths)))
    want = port_core.solve_block_status(graph, D, backend="cuda",
                                        device="cpu")
    ba = port_dse._batch_arrays(graph)
    assert ("sparse", "cpu") in ba.on_device
    ba2 = pickle.loads(pickle.dumps(ba))
    assert ba2.on_device == {} and ("sparse", "cpu") in ba.on_device
    assert (ba2.perm == ba.perm).all() and ba2.bound == ba.bound
    g2 = pickle.loads(pickle.dumps(graph))
    assert g2.batch.on_device == {}
    got = port_core.solve_block_status(g2, D, backend="cuda", device="cpu")
    for a, b in zip(got[:3], want[:3]):
        assert (a == b).all()
    numpy_lane = port_core.solve_block_status(g2, D, backend="numpy")
    for a, b in zip(numpy_lane[:3], want[:3]):
        assert (a == b).all()


# ------------------------------------------------------------ fingerprint
def _closure_design(captured):
    from repro_torch.core.program import Emit, Program, Read, Write

    prog = Program("closure_design", declared_type="A")
    d = prog.fifo("d", 2)

    @prog.module("p")
    def p():
        for i in range(4):
            yield Write(d, i)

    @prog.module("c")
    def c():
        tot = 0
        for _ in range(4):
            tot += (yield Read(d))
        yield Emit("sum", tot + (captured is not None))

    return prog


def test_fingerprint_content_addressing():
    fp = port_core.program_fingerprint
    k1 = fp(port_typea.producer_consumer(n=32, depth=2))
    assert k1 == fp(port_typea.producer_consumer(n=32, depth=2))
    assert k1 != fp(port_typea.producer_consumer(n=48, depth=2))
    assert k1 != fp(port_typea.producer_consumer(n=32, depth=3))


def test_fingerprint_closure_edge_cases():
    fp = port_core.program_fingerprint

    def nest(v, levels=12):
        for _ in range(levels):
            v = [v]
        return v

    assert fp(_closure_design(nest(1))) != fp(_closure_design(nest(2)))

    class Cfg:                           # default object.__repr__
        def __init__(self, x):
            self.x = x

    assert fp(_closure_design(Cfg(1))) == fp(_closure_design(Cfg(1)))
    assert fp(_closure_design(Cfg(1))) != fp(_closure_design(Cfg(2)))
    assert fp(_closure_design((4, 8))) != fp(_closure_design([4, 8]))
    assert (fp(_closure_design(np.arange(3)))
            != fp(_closure_design(np.arange(4))))


def test_fingerprint_kwonly_defaults_and_globals():
    from repro_torch.core.program import Emit, Program

    fp = port_core.program_fingerprint

    def build(count):
        prog = Program("kwonly", declared_type="A")

        def gen(*, n=count):
            yield Emit("n", n)

        prog.add_module("m", gen)
        return prog

    assert fp(build(3)) == fp(build(3)) != fp(build(7))

    def build_global(src, n):
        g = {"Emit": Emit, "N": n}
        exec(src, g)
        prog = Program("globdesign", declared_type="A")
        prog.add_module("m", g["gen"])
        return prog

    for src in ("def gen():\n    yield Emit('n', N)\n",
                "def gen():\n    f = lambda: N\n    yield Emit('n', f())\n"):
        assert fp(build_global(src, 3)) == fp(build_global(src, 3))
        assert fp(build_global(src, 3)) != fp(build_global(src, 7))


def test_module_content_hash_depth_flavors():
    prog = port_typea.producer_consumer(n=32, depth=2)
    other = port_typea.producer_consumer(n=32, depth=5)
    h = port_core.module_content_hash
    fn, fn2 = prog.modules[0].fn, other.modules[0].fn
    assert h(fn, fifo_depth=False) == h(fn2, fifo_depth=False)
    assert h(fn) != h(fn2)
    memo = {}
    assert h(fn, fifo_depth=False, memo=memo) == h(fn, fifo_depth=False)


# ----------------------------------------------------------------- search
def search_strategies(pkg, lane):
    s = pkg.sweep
    out = {}
    with _service(pkg, lane, block=8) as svc:
        build = lambda: pkg.typea.producer_consumer(n=32, depth=2)
        for mode, vals in (("uniform", [1, 2, 4, 8]), ("axes", [1, 4]),
                           ("product", [1, 2])):
            r = s.grid_search(svc, build(), vals, mode=mode)
            out[mode] = (r.depths.tolist(), r.cycles.tolist(),
                         r.feasible.tolist(), r.pareto, r.best)
        with pytest.raises(ValueError):
            s.grid_search(svc, pkg.typea.skynet_like(items=24, depth=4),
                          list(range(9)), mode="product", limit=10)
    with _service(pkg, lane, block=16) as svc:
        r = s.random_search(svc, pkg.typea.producer_consumer(n=24, depth=2),
                            n=24, lo=1, hi=8, seed=2)
        out["random"] = (r.depths.tolist(), r.cycles.tolist(), r.pareto,
                         r.best)
    with _service(pkg, lane, block=32) as svc:
        r = s.successive_halving(svc, pkg.typea.skynet_like(items=24,
                                                            depth=4),
                                 n0=8, rounds=3, eta=2, lo=1, hi=12, seed=4)
        out["halving"] = (r.depths.tolist(), r.cycles.tolist(), r.pareto,
                          r.best, r.rounds, svc.stats()["scheduler"]["rows"])
    return out


@pytest.mark.parametrize("lane", PORT_LANES)
def test_search_strategies_match_the_reference(lane):
    got = search_strategies(PORT, lane)
    assert got == _ref(search_strategies)
    # every frontier point is exact, and halving explored toward less area
    _d, _c, pareto, best, rounds, rows = got["halving"]
    assert rounds == 3 and rows == len(_d) < 8 * 3
    for dv, _area, cyc in pareto:
        assert port_core.simulate(port_typea.skynet_like(items=24, depth=4),
                                  depths=dv).cycles == cyc
    n0 = np.asarray(_d[:8])
    feas0 = np.asarray(_c[:8]) >= 0
    assert pareto[0][1] <= int(n0[feas0].sum(axis=1).min())


def test_pareto_front_dominance():
    D = np.array([[1, 1], [2, 2], [3, 3], [4, 4], [2, 1]])
    C = np.array([100, 50, 50, 40, 60])
    assert port_sweep.pareto_front(D, C) == [
        ((1, 1), 2, 100), ((2, 1), 3, 60), ((2, 2), 4, 50), ((4, 4), 8, 40)]
    feas = np.array([True, True, True, False, True])
    assert all(a != 8 for _d, a, _c in port_sweep.pareto_front(D, C, feas))


def test_feasible_mask_excludes_service_terminal_statuses():
    d = port_dse
    status = np.array([d.REUSED, d.FAULTED, d.TIMED_OUT, d.REJECTED,
                       d.CANCELLED, d.CYCLE], dtype=np.int8)
    K = len(status)
    out = d.BatchOutcome(ok=status == d.REUSED,
                         cycles=np.arange(10, 10 + K, dtype=np.int64),
                         status=status, violated=np.zeros(K, np.int64),
                         reasons=[""] * K, results=[None] * K, elapsed_s=0.0)
    assert _feasible_mask(out).tolist() == [True, False, False, False,
                                            False, True]


def test_search_excludes_faulted_rows():
    inj = port_sweep.FaultInjector(seed=3).arm("shard.fault", at=[0, 2])
    with _service(PORT, {"backend": "cuda", "device": "cpu"}, block=8,
                  shards=2, min_shard_rows=1, injector=inj,
                  retry=port_sweep.RetryPolicy(max_attempts=2,
                                               backoff_s=0.0)) as svc:
        out = port_sweep.grid_search(
            svc, port_typea.producer_consumer(n=32, depth=4),
            [1, 2, 3, 4, 5, 6, 7, 8])
    faulted = np.asarray(out.cycles) == -1
    assert faulted.any() and not out.feasible[faulted].any()
    assert out.feasible[~faulted].all() and out.best is not None
    front = {dv for dv, _a, _c in out.pareto}
    for k in np.flatnonzero(faulted):
        assert tuple(int(x) for x in out.depths[k]) not in front


def test_successive_halving_edge_cases():
    from repro_torch.core.program import Program, Read, Write

    with _service(PORT, {"backend": "numpy"}, block=8) as svc:
        out = port_sweep.successive_halving(
            svc, port_typea.producer_consumer(n=16, depth=2), n0=0)
    assert out.depths.shape == (0, 1) and out.rounds == 0
    assert out.pareto == [] and out.best is None
    assert out.summary().startswith("0 evaluated")

    def exchange(K=6):
        prog = Program("sh_dead", declared_type="B")
        ab = prog.fifo("ab", K)
        ba = prog.fifo("ba", K)

        @prog.module("x")
        def x():
            for i in range(K):
                yield Write(ab, i)
            for _ in range(K):
                yield Read(ba)

        @prog.module("y")
        def y():
            for i in range(K):
                yield Write(ba, i)
            for _ in range(K):
                yield Read(ab)

        return prog

    with _service(PORT, {"backend": "cuda", "device": "cpu"},
                  block=16) as svc:
        out = port_sweep.successive_halving(svc, exchange(), n0=4, rounds=5,
                                            eta=2, lo=1, hi=5, seed=1)
    assert not out.feasible.any() and out.best is None and out.rounds == 1
