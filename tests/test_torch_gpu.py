"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version on the same inputs, and the device lanes against the
port's exact host oracle.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one: a CUDA kernel has no CPU mode, and its plain version is what the CPU
tests hold against the reference.  This file imports only the port (no
``jax``, no ``repro``), so it runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.dse as tdse
from repro_torch.core import compile_graph, resimulate_batch, simulate
from repro_torch.designs.dynamic import watchdog_pipe
from repro_torch.designs.paper import fig2_timer, fig4_ex5
from repro_torch.designs.typea import (matmul_stream, merge_sort_staged,
                                       producer_consumer, skynet_like)
from repro_torch.kernels import _cuda
from repro_torch.kernels.maxplus import kernel, ops, ref, sparse

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("K,N", [(1, 5), (3, 300), (2, 1024), (1, 1030)])
def test_dense_sweep_matches_plain_version(dev, K, N):
    """Odd N takes the scalar path, N % 4 == 0 the 16-byte one, N > 1024
    the tiled staging of t."""
    rng = np.random.default_rng(N)
    a = rng.integers(-8, 8, size=(K, N, N)).astype(np.int32)
    a[rng.random(a.shape) < 0.5] = kernel.NEG
    t = rng.integers(-99, 99, size=(K, N)).astype(np.int32)
    b = rng.integers(-99, 99, size=N).astype(np.int32)
    a, t, b = (torch.from_numpy(x).to(dev) for x in (a, t, b))
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    before = _cuda.DENSE.launches
    got = kernel.maxplus_sweep(a, t, b, flag)
    assert _cuda.DENSE.launches == before + 1
    assert torch.equal(got, ref.maxplus_sweep_ref(a, t, b))
    assert int(flag.item()) == int(bool((got != t).any()))
    per_row = kernel.maxplus_sweep(a, t, b.expand(K, N).contiguous())
    assert torch.equal(per_row, got)


def test_dense_sentinels_do_not_overflow(dev):
    """-INF + -INF is exactly INT32_MIN; the kernel must not wrap it."""
    a = torch.full((1, 8, 8), kernel.NEG, dtype=torch.int32, device=dev)
    t = torch.full((1, 8), kernel.NEG, dtype=torch.int32, device=dev)
    out = kernel.maxplus_sweep(a, t, t[0])
    assert (out == kernel.NEG).all()


def test_finalize_times_matches_engine(dev):
    res = simulate(producer_consumer(n=40, depth=2))
    got = ops.finalize_times(res.graph.graph, device=dev)
    assert np.array_equal(got.cpu().numpy(), res.graph.graph.times())


def test_sparse_fixpoint_matches_plain_version(dev):
    g = compile_graph(simulate(skynet_like(items=24, depth=4)).graph)
    ba = tdse._batch_arrays(g)
    D = np.random.default_rng(1).integers(1, 9, size=(64, len(g.fifos)))
    before = _cuda.SPARSE.launches
    t_k, c_k, rounds = tdse._solve_sparse_cuda(g, ba, D, dev)
    assert _cuda.SPARSE.launches - before == rounds > 0
    arr = tdse._sparse_arrays(ba, dev)
    t_p, c_p, rounds_p = ref.solve_chains_ref(
        arr, torch.from_numpy(D.astype(np.int32)).to(dev))
    # the plain version stops at the first round that changes nothing;
    # the kernel's loop reads its flag once per batch of rounds
    assert rounds_p <= rounds < rounds_p + _cuda.CHECK_CAP
    assert torch.equal(c_k, c_p)
    assert torch.equal(t_k[:, c_k], t_p[:, c_p])


def test_segmented_fixpoint_on_long_chains_matches_plain_version(dev):
    """``chip_smoke.py``'s synthetic chain graph with 3 chains of 1 000 to
    3 000 nodes (lengths that are not multiples of the segment length),
    K = 1 000 (not a multiple of 4: the scalar path) and depths 1-64,
    under which about a third of the rows form WAR cycles: the kernel's
    times and converged mask on every row equal the plain version's, bit
    for bit."""
    from repro_torch.core.graph import export_chain_flat
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(14)
    n, args = smoke.synthetic_chain_graph(rng, chains=3, lens=(1000, 3000))
    arr = sparse.to_device(export_chain_flat(*args, neg=sparse.NEG), dev)
    L = int((arr.seg_hi - arr.seg_lo).max())
    lens = (arr.chain_hi - arr.chain_lo).tolist()
    assert all(x % L for x in lens), (lens, L)
    D = torch.from_numpy(rng.integers(1, 65, size=(1000, 6))
                         .astype(np.int32)).to(dev)
    before = _cuda.SPARSE.launches
    t_k, c_k, rounds = sparse.solve_chains(arr, D)
    assert _cuda.SPARSE.launches - before == rounds
    t_p, c_p, rounds_p = ref.solve_chains_ref(arr, D)
    assert rounds_p <= rounds < rounds_p + _cuda.CHECK_CAP
    assert 0 < int(c_p.sum()) < 1000          # some rows are WAR cycles
    assert torch.equal(c_k, c_p)
    # a row frozen as diverged keeps the times of its last chain pass in
    # both versions, so every row's times agree
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("lane", ["cuda", "cuda_dense"])
@pytest.mark.parametrize("name,build,hi", [
    ("merge_sort_staged", lambda: merge_sort_staged(5), 8),
    ("fig4_ex5", lambda: fig4_ex5(n=96), 8),
    ("skynet_like", lambda: skynet_like(items=48, depth=6), 12),
])
def test_device_lanes_match_host_oracle(dev, lane, name, build, hi):
    base = simulate(build())
    D = np.random.default_rng(0).integers(1, hi + 1,
                                          size=(48, len(base.depths)))
    want = resimulate_batch(base, D, backend="numpy")
    got = resimulate_batch(base, D, backend=lane, device=dev)
    assert (want.status == got.status).all(), name
    assert (want.cycles == got.cycles).all(), name
    assert (want.violated == got.violated).all(), name
    assert want.reasons == got.reasons, name


def test_war_cycle_rows_are_cycles_on_the_card(dev):
    from repro_torch.core import Emit, Program, Read, Write

    prog = Program("burst_pingpong")
    cmd, resp = prog.fifo("cmd", 8), prog.fifo("resp", 8)

    @prog.module("ctrl")
    def ctrl():
        for i in range(8):
            yield Write(cmd, i)
        tot = 0
        for _ in range(8):
            tot += (yield Read(resp))
        yield Emit("sum", tot)

    @prog.module("proc")
    def proc():
        for _ in range(8):
            v = yield Read(cmd)
            yield Write(resp, 2 * v)

    base = simulate(prog)
    D = np.array([(1, 1), (2, 2), (1, 8), (8, 1), (4, 4), (8, 8)])
    for lane in ("cuda", "cuda_dense"):
        out = resimulate_batch(base, D, backend=lane, device=dev,
                               fallback=False)
        assert out.status.tolist()[:2] == [tdse.CYCLE] * 2, lane
        assert (out.status[2:] == tdse.REUSED).all(), lane


@pytest.mark.parametrize("name,build,hi", [
    ("merge_sort_staged", lambda: merge_sort_staged(5), 8),
    ("skynet_like", lambda: skynet_like(items=48, depth=6), 12),
    ("matmul_stream", lambda: matmul_stream(m=6, k=6, n=6), 8),
])
def test_trace_built_graph_resolves_like_the_generator_built(dev, name,
                                                             build, hi):
    """Compiled replay's graph (chain-major node ids) and the generator
    engine's (creation order) through kernel 1: status, cycles and
    violated counts bit for bit, and against the host lane."""
    tr, gen = simulate(build()), simulate(build(), trace="never")
    assert tr.engine == "omnisim-trace" and gen.engine == "omnisim"
    D = np.random.default_rng(3).integers(1, hi + 1,
                                          size=(256, len(tr.depths)))
    before = _cuda.SPARSE.launches
    a = tdse.solve_block_status(compile_graph(tr.graph), D, backend="cuda",
                                device=dev)
    assert _cuda.SPARSE.launches > before
    b = tdse.solve_block_status(compile_graph(gen.graph), D, backend="cuda",
                                device=dev)
    want = tdse.solve_block_status(compile_graph(tr.graph), D[:32],
                                   backend="numpy")
    for x, y, z in zip(a[:3], b[:3], want[:3]):
        assert np.array_equal(x, y), name
        assert np.array_equal(x[:32], z), name


def test_finalize_times_on_a_trace_graph(dev):
    """Kernel 2 on the trace graph's CSR: its own times, bit for bit."""
    res = simulate(merge_sort_staged(5))
    assert res.engine == "omnisim-trace"
    before = _cuda.DENSE.launches
    got = ops.finalize_times(res.graph.graph, device=dev)
    assert _cuda.DENSE.launches > before
    assert np.array_equal(got.cpu().numpy(), res.graph.graph.times())


@pytest.mark.parametrize("name,build,hi", [
    ("fig4_ex5", lambda: fig4_ex5(n=256), 8),
    ("watchdog_pipe", lambda: watchdog_pipe(items=256, stages=3, depth=8,
                                            poll_gap=16), 16),
    ("fig2_timer", lambda: fig2_timer(n=128), 8),
])
def test_hybrid_built_graph_resolves_like_the_generator_built(dev, name,
                                                              build, hi):
    """The hybrid replay's graph (nodes numbered module by module, NB and
    probe constraints included) and the generator engine's (creation
    order) through kernel 1: status, cycles and violated counts bit for
    bit, the same rounds, and against the host lane; and the
    ``resimulate_batch`` fallback verdicts on the card equal the host
    lane's."""
    hy, gen = simulate(build()), simulate(build(), trace="never")
    assert hy.engine == "omnisim-hybrid" and gen.engine == "omnisim"
    D = np.random.default_rng(0).integers(1, hi + 1,
                                          size=(128, len(hy.depths)))
    before = _cuda.SPARSE.launches
    a = tdse.solve_block_status(compile_graph(hy.graph), D, backend="cuda",
                                device=dev)
    assert _cuda.SPARSE.launches > before
    b = tdse.solve_block_status(compile_graph(gen.graph), D, backend="cuda",
                                device=dev)
    want = tdse.solve_block_status(compile_graph(hy.graph), D[:32],
                                   backend="numpy")
    for x, y, z in zip(a[:3], b[:3], want[:3]):
        assert np.array_equal(x, y), name
        assert np.array_equal(x[:32], z), name
    assert a[3] == b[3], name
    o = resimulate_batch(hy, D[:16], backend="cuda", device=dev)
    w = resimulate_batch(hy, D[:16], backend="numpy")
    assert np.array_equal(o.status, w.status) and np.array_equal(o.cycles,
                                                                 w.cycles)


def test_finalize_times_on_a_hybrid_graph(dev):
    """Kernel 2 on the hybrid graph's CSR: its own times, bit for bit."""
    res = simulate(fig4_ex5(n=256))
    assert res.engine == "omnisim-hybrid"
    before = _cuda.DENSE.launches
    got = ops.finalize_times(res.graph.graph, device=dev)
    assert _cuda.DENSE.launches > before
    assert np.array_equal(got.cpu().numpy(), res.graph.graph.times())


# ------------------------------------------------------------ sweep service
def _worker_sparse_launches(pause):
    """(pid, kernel 1's launches) in a process-shard worker; the pause
    lets every worker of the pool take one of the probes."""
    import os
    import time

    time.sleep(pause)
    return os.getpid(), _cuda.SPARSE.launches


@pytest.mark.parametrize("mode,shards", [("serial", 1), ("thread", 2),
                                         ("process", 2)])
def test_sweep_service_on_the_card_matches_numpy(dev, mode, shards):
    """The service on ``backend="cuda"`` (its default) serves every row
    bit for bit as the host oracle does, with no faulted row, and its
    shards launched kernel 1 (process workers count in their own
    processes)."""
    from repro_torch.sweep import SweepService

    rng = np.random.default_rng(0)
    designs = [(lambda: merge_sort_staged(5), 8), (lambda: fig4_ex5(n=96), 8)]
    _cuda.SPARSE.reset_counts()
    with SweepService(block=32, shards=shards, mode=mode,
                      min_shard_rows=1, autostart=mode != "serial") as svc:
        for build, hi in designs:
            base = simulate(build())
            D = rng.integers(1, hi + 1, size=(96, len(base.depths)))
            want = resimulate_batch(base, D, backend="numpy")
            got = svc.sweep(build(), D)
            assert (want.status == got.status).all()
            assert (want.cycles == got.cycles).all()
            assert (want.violated == got.violated).all()
            assert want.reasons == got.reasons
            for a, b in zip(want.results, got.results):
                assert (a is None) == (b is None)
                if a is not None:
                    assert (a.cycles, a.outputs, a.deadlock) == \
                        (b.cycles, b.outputs, b.deadlock)
        st = svc.stats()["scheduler"]
        if mode == "process":
            assert svc.scheduler._pool._mp_context.get_start_method() \
                == "spawn"
            probes = [svc.scheduler._pool.submit(_worker_sparse_launches,
                                                 0.2) for _ in range(8)]
            counts = dict(f.result(timeout=300) for f in probes)
        else:
            counts = {"this process": _cuda.SPARSE.launches}
    assert st["faulted_rows"] == st["timed_out_rows"] == st["retries"] == 0
    assert sum(counts.values()) > 0, counts


def test_sweep_service_builds_the_kernel_library_at_construction(
        dev, tmp_path, monkeypatch):
    from repro_torch.sweep import SweepService

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    base = simulate(merge_sort_staged(5))
    D = np.random.default_rng(1).integers(1, 9, size=(16, len(base.depths)))
    want = resimulate_batch(base, D, backend="numpy")
    for lib, backend in ((_cuda.SPARSE, "cuda"),
                         (_cuda.DENSE, "cuda_dense")):
        monkeypatch.setattr(lib, "_lib", None)
        assert not lib.target().exists()
        with SweepService(backend=backend, autostart=False) as svc:
            assert lib.target().exists() and lib._lib is not None
            lib.reset_counts()
            got = svc.sweep(base, D)
            assert lib.launches > 0, backend
            assert svc.stats()["scheduler"]["faulted_rows"] == 0
        assert (want.status == got.status).all()
        assert (want.cycles == got.cycles).all()


# ------------------------------------------- edit sessions and the corpus
def test_delta_edit_session_on_the_card_serves_a_patched_design(dev):
    """An edit session of ``SweepService()`` (``backend="cuda"``): the
    ``delay`` edit is served ``patched``, bit-identical to a cold
    ``simulate``, and its sweep rows through kernel 1 equal those of a
    cold-built base of the edited design, and the host oracle's."""
    from repro_torch.corpus import edit_pairs, result_record
    from repro_torch.sweep import SweepService

    p = {q.kind: q for q in edit_pairs(3, scale=28)}["delay"]
    cold = simulate(p.edited())
    D = np.random.default_rng(0).integers(1, 7, size=(64, len(cold.depths)))
    with SweepService(autostart=False) as svc:
        sess = svc.edit_session(p.base())
        out = sess.update(p.edited())
        assert out.mode == "patched" and out.reuse_fraction >= 0.9
        assert result_record(sess.entry.result) == result_record(cold)
        _cuda.SPARSE.reset_counts()
        served = sess.sweep(D)
        assert _cuda.SPARSE.launches > 0
    direct = resimulate_batch(cold, D, backend="cuda", device=dev)
    host = resimulate_batch(cold, D, backend="numpy")
    for want in (direct, host):
        assert (served.status == want.status).all()
        assert (served.cycles == want.cycles).all()
        assert (served.violated == want.violated).all()
        assert served.reasons == want.reasons


def test_corpus_conformance_on_the_card(dev):
    """Every engine path of a 32-module corpus design, with the ``"cuda"``
    and ``"sweep"`` paths on the card."""
    from repro_torch.corpus import check_conformance, generate

    c = generate(3, scale=32)
    _cuda.SPARSE.reset_counts()
    rep = check_conformance(c.builder, name=c.name, device="cuda")
    assert rep.ok and not rep.deadlock
    assert rep.paths["cuda"] == rep.paths["sweep"] == "ok"
    assert _cuda.SPARSE.launches > 0


def test_delta_edit_session_needs_the_kernel_library(dev, monkeypatch):
    """No edit session without kernel 1: the service raises at
    construction when the library does not build."""
    from repro_torch.corpus import edit_pairs
    from repro_torch.sweep import SweepService

    def no_nvcc():
        raise RuntimeError("nvcc failed for maxplus_sparse.cu")

    base = edit_pairs(3, scale=28)[0].base()
    monkeypatch.setattr(_cuda.SPARSE, "lib", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        SweepService().edit_session(base)


# ---------------------------------------------------------- flash attention
def _flash_inputs(dev, dtype, B, S, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B * h, S, hd))
                             .astype(np.float32)).to(dev, dtype)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("S,window,softcap,causal", [
    (128, 0, 0.0, True),
    (1, 0, 0.0, True),           # one row, one key
    (63, 0, 0.0, True),          # ragged S, one partial q tile
    (65, 0, 0.0, True),          # one row past a full tile
    (1000, 0, 0.0, True),        # ragged S
    (333, 100, 50.0, True),      # window and softcap, ragged
    (200, 0, 30.0, False),       # not causal
    (257, 1, 0.0, True),         # window 1: only the diagonal is kept
])
@pytest.mark.parametrize("group", [1, 3, 4])
def test_flash_kernel_matches_plain_version(dev, dtype, hd, S, window,
                                            softcap, causal, group):
    """bf16 takes the tensor-core route: P is rounded to bf16 before P.V
    and the output to bf16 once, so the two differ by about one bf16 step
    of the output (|o| <~ 3): 2e-2.  f32 takes the FMA route: summation
    order only: 2e-5.  Each launch counts under its route only."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    tdt = getattr(torch, dtype)
    route = "tensor_core_bf16" if dtype == "bfloat16" else "fma_f32"
    q, k, v = _flash_inputs(dev, tdt, 2, S, 2 * group, 2, hd,
                            seed=S + hd + group)
    before = _cuda.FLASH.launches
    routes = dict(_cuda.FLASH.route_launches)
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                  softcap=softcap, group_size=group)
    torch.cuda.synchronize()
    assert _cuda.FLASH.launches == before + 1
    assert _cuda.FLASH.route_launches == {
        r: n + (r == route) for r, n in routes.items()}
    want = fr.attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap, group_size=group)
    assert got.dtype == tdt and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.flash_attention import kernel as fk
    q, k, v = _flash_inputs(dev, torch.float32, 1, 64, 2, 1, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fk.flash_attention_bhsd(q.half(), k.half(), v.half(), group_size=2)
    q48, k48, v48 = _flash_inputs(dev, torch.float32, 1, 64, 2, 1, 48)
    with pytest.raises(ValueError, match="hd in"):
        fk.flash_attention_bhsd(q48, k48, v48, group_size=2)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_bhsd(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), k, v, group_size=2)
    with pytest.raises(ValueError, match="is on"):
        fk.flash_attention_bhsd(q, k.cpu(), v, group_size=2)
    with pytest.raises(ValueError, match="must be"):
        fk.flash_attention_bhsd(q, k, v, group_size=1)


def test_prefill_step_launches_one_kernel_per_layer(dev):
    """The smoke model's prefill on the card against the same model on the
    CPU (plain version): f32, so the tolerance is the f32 summation
    order's; it takes the f32 route once per layer.  In bf16 it takes the
    tensor-core route once per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.train.step import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("gemma2-2b").smoke().replace(sliding_window=16,
                                                local_global_pattern=True)
    params = api.init_params(0, cfg, device=dev)
    cpu_params = api.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 77)))
    before = _cuda.FLASH.launches
    routes = dict(_cuda.FLASH.route_launches)
    got = make_prefill_step(cfg)(params, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert _cuda.FLASH.launches - before == cfg.num_layers
    assert _cuda.FLASH.route_launches == {
        "fma_f32": routes["fma_f32"] + cfg.num_layers,
        "tensor_core_bf16": routes["tensor_core_bf16"]}
    want = make_prefill_step(cfg)(cpu_params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out16 = make_prefill_step(cfg.replace(dtype="bfloat16"))(
        params, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out16.float()).all())
    assert _cuda.FLASH.route_launches == {
        "fma_f32": routes["fma_f32"] + cfg.num_layers,
        "tensor_core_bf16": routes["tensor_core_bf16"] + cfg.num_layers}


# ------------------------------------------------------------- mlstm chunk
def _mlstm_inputs(dev, BH, S, P, Pv, seed=0, gate_bias=1.0):
    """q scaled by 1/sqrt(P) as the model scales it; ig a sigmoid, la a
    log-sigmoid (<= 0) of a normal plus ``gate_bias``: 1 forgets most of
    the state within a chunk, 8 keeps it over many chunks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, P)) / np.sqrt(P)
    k = rng.standard_normal((BH, S, P))
    v = rng.standard_normal((BH, S, Pv))
    ig = 1 / (1 + np.exp(-rng.standard_normal((BH, S))))
    la = -np.logaddexp(0, -(rng.standard_normal((BH, S)) + gate_bias))
    return [torch.from_numpy(x.astype(np.float32)).to(dev)
            for x in (q, k, v, ig, la)]


@pytest.mark.parametrize("BH,S,P,Pv,chunk,gate_bias", [
    (6, 128, 64, 65, 32, 1.0),       # the reference test's odd widths
    (6, 256, 32, 32, 64, 1.0),
    (2, 256, 32, 33, 256, 1.0),      # one chunk, 256 rows
    (2, 16, 64, 65, 16, 1.0),        # S = chunk
    (3, 24, 20, 7, 12, 1.0),         # ragged tiles everywhere
    (1, 300, 40, 70, 150, 1.0),
    (2, 1024, 24, 41, 512, 1.0),     # chunk > 256: two y passes a chunk
    (2, 512, 1024, 1025, 256, 1.0),  # xlstm-1.3b's widths and chunk
    (3, 192, 48, 17, 48, 1.0),       # Pv = 17 = 1 mod 8: a lone column
    (2, 2048, 32, 33, 16, 8.0),      # 128 chunks, the state carried
])
def test_mlstm_kernel_matches_plain_version(dev, BH, S, P, Pv, chunk,
                                            gate_bias):
    """f32 throughout; the chunked kernel (split-bf16 products on the
    tensor cores, f32 state) and the direct O(S^2) plain version sum in
    another order: the reference's 2e-4 (relative to the readout's scale,
    |y| up to ~20 at P 1024)."""
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.kernels.mlstm_chunk import ref as mr
    xs = _mlstm_inputs(dev, BH, S, P, Pv, seed=S + P, gate_bias=gate_bias)
    before = _cuda.MLSTM.launches
    got = mk.mlstm_chunk_bhsd(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert _cuda.MLSTM.launches == before + 1
    want = mr.mlstm_ref(*xs)
    assert got.dtype == torch.float32 and got.shape == (BH, S, Pv)
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * scale)


def test_mlstm_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    q, k, v, ig, la = _mlstm_inputs(dev, 2, 64, 32, 33)
    with pytest.raises(ValueError, match="float32"):
        mk.mlstm_chunk_bhsd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                            ig, la, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mlstm_chunk_bhsd(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, ig, la, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mk.mlstm_chunk_bhsd(q, k, v, ig, la, chunk=48)
    with pytest.raises(ValueError, match="is on"):
        mk.mlstm_chunk_bhsd(q, k.cpu(), v, ig, la, chunk=32)
    # the CUDA routine's own checks: a block keeps its [32, P] state tile
    # in registers, 1024 columns at most, whatever the chunk (P 2048 at
    # chunk 256, P 1040 at chunk 16); a chunk's v tile and two ring stages
    # must fit its shared memory (chunk 1024 does not); 65 536 chunks
    # exceed the score grid's z limit
    for S, P, chunk in ((256, 2048, 256), (64, 1040, 16), (1024, 16, 1024)):
        big = _mlstm_inputs(dev, 1, S, P, 8)
        with pytest.raises(RuntimeError, match="CUDA error"):
            mk.mlstm_chunk_bhsd(*big, chunk=chunk)
    many = _mlstm_inputs(dev, 1, 65536, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mk.mlstm_chunk_bhsd(*many, chunk=1)
    ok = _mlstm_inputs(dev, 1, 1024, 16, 8)      # the largest chunk taken
    assert torch.isfinite(mk.mlstm_chunk_bhsd(*ok, chunk=512)).all()


def test_xlstm_prefill_launches_one_kernel_per_mlstm_block(dev):
    """A smoke xlstm (two supergroups of two mLSTM blocks) on the card
    against the same model on the CPU (plain version): f32, so the
    tolerance is the f32 summation order's; and ServeEngine's tokens on
    the card equal the CPU's."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.step import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("xlstm-1.3b").smoke()
    cfg = cfg.replace(num_layers=6, xlstm=dataclasses.replace(
        cfg.xlstm, slstm_every=3))
    params = api.init_params(0, cfg, device=dev)
    cpu_params = api.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    before = _cuda.MLSTM.launches
    got = make_prefill_step(cfg)(params, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    assert _cuda.MLSTM.launches - before == 4
    want = make_prefill_step(cfg)(cpu_params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    prompts = toks[:, :5].numpy()
    assert np.array_equal(ServeEngine(cfg, params, 2, 16).generate(prompts, 4),
                          ServeEngine(cfg, cpu_params, 2, 16).generate(
                              prompts, 4))


# ---------------------------------------------------------- training, int8
def test_flash_kernel_at_minicpms_mha_shape(dev):
    """minicpm-2b's attention: 36 query heads over 36 K/V heads (group
    size 1), hd 64, bf16, causal, on the tensor-core route; the bf16
    tolerance of chip_smoke.py phase 8 (one bf16 step, 2^-7, or 1e-3)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 1024, 36, 36, 64,
                            seed=36)
    routes = dict(_cuda.FLASH.route_launches)
    got = fk.flash_attention_bhsd(q, k, v, group_size=1)
    torch.cuda.synchronize()
    assert _cuda.FLASH.route_launches["tensor_core_bf16"] == \
        routes["tensor_core_bf16"] + 1
    want = fr.attention_ref(q, k, v, group_size=1)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def test_the_kernel_lane_raises_under_grad_on_the_card(dev):
    """The CUDA kernels have no backward: handed tensors that require grad
    they raise before launching, and the models' kernel lane with them."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    from repro_torch.models import api, lm
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 64, 2, 1, 64)
    before = (_cuda.FLASH.launches, _cuda.MLSTM.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        fk.flash_attention_bhsd(q.requires_grad_(), k, v, group_size=2)
    qm, km, vm, ig, la = _mlstm_inputs(dev, 2, 32, 16, 17)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.mlstm_chunk_bhsd(qm, km.requires_grad_(), vm, ig, la, chunk=16)
    for name in ("smollm-135m", "xlstm-1.3b"):
        cfg = get_arch(name).smoke()
        params = api.init_params(0, cfg, device=dev)
        toks = torch.zeros(1, 16, dtype=torch.long, device=dev)
        with pytest.raises(RuntimeError, match="no backward"):
            lm.hidden_forward(params, toks, cfg)
    assert (_cuda.FLASH.launches, _cuda.MLSTM.launches) == before


@pytest.mark.parametrize("name", ["smollm-135m", "xlstm-1.3b"])
def test_train_step_on_the_card_matches_the_cpu(dev, name):
    """One make_train_step (f32, from step 150 so the update moves the
    weights) on the card and on the CPU from the same weights and batch:
    loss, grad norm and the updated weights within 1e-4; no kernel of
    ours launched (the training lane is plain torch)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).smoke()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    out = {}
    for d in (dev, torch.device("cpu")):
        params = api.init_params(0, cfg, device=d)
        opt = init_adamw(params)
        opt = opt._replace(step=opt.step + 150)
        batch = {"tokens": torch.from_numpy(toks).to(d),
                 "targets": torch.from_numpy(np.roll(toks, -1, 1)).to(d)}
        before = (_cuda.FLASH.launches, _cuda.MLSTM.launches)
        params, opt, m = make_train_step(cfg, cast_bf16=False)(
            params, opt, batch)
        assert (_cuda.FLASH.launches, _cuda.MLSTM.launches) == before
        out[d.type] = (m, {n: p.detach().cpu()
                           for n, p in params.named_parameters()})
    (mg, pg), (mc, pc) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-4,
                                   atol=0)
    for n in pc:
        torch.testing.assert_close(pg[n], pc[n], rtol=1e-4, atol=1e-4)


def test_int8_decode_on_the_card_matches_the_cpu(dev):
    """minicpm-2b's smoke config (kv_quant on): six decode steps on the
    card and on the CPU, logits within 1e-3 (f32 compute; the int8 rows
    may differ by one LSB at rounding ties)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("minicpm-2b").smoke()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)))
    logits = {}
    for d in (dev, torch.device("cpu")):
        params = api.init_params(0, cfg, device=d)
        cache = api.init_cache(cfg, 2, 8, device=d)
        assert cache["k"].dtype == torch.int8
        logits[d.type] = []
        for t in range(6):
            lg, cache = api.decode_step(params, toks[:, t:t + 1].to(d),
                                        cache, cfg)
            logits[d.type].append(lg.cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


# ------------------------------------------- moe, hybrid, vlm, encdec
@pytest.mark.parametrize("H,Hkv,S,window", [
    (24, 8, 2048, 0),            # granite-moe-3b-a800m, group size 3
    (25, 5, 2048, 1024),         # hymba-1.5b, group size 5, windowed
    (14, 2, 2304, 0),            # internvl2-1b, 256 patches + 2048 tokens
    (16, 16, 2048, 0),           # seamless-m4t-medium's decoder
])
def test_flash_kernel_at_the_new_families_shapes(dev, H, Hkv, S, window):
    """The group sizes 3, 5 and 7 and the 1024 window at hd 64, bf16, on
    the tensor-core route; the tolerance of chip_smoke.py phase 8."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, S, H, Hkv, 64, seed=H)
    routes = dict(_cuda.FLASH.route_launches)
    got = fk.flash_attention_bhsd(q, k, v, window=window, group_size=H // Hkv)
    torch.cuda.synchronize()
    assert _cuda.FLASH.route_launches["tensor_core_bf16"] == \
        routes["tensor_core_bf16"] + 1
    want = fr.attention_ref(q, k, v, window=window, group_size=H // Hkv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


@pytest.mark.parametrize("name,kw", [
    ("granite-moe-3b-a800m", {}), ("qwen3-moe-30b-a3b", {}),
    ("hymba-1.5b", dict(sliding_window=8)), ("internvl2-1b", {}),
    ("seamless-m4t-medium", {})])
def test_new_families_on_the_card_match_the_cpu(dev, name, kw):
    """Smoke config, f32 (TF32 off), the same weights on the card and on
    the CPU: the prefill step (the flash kernel once per decoder layer,
    f32 route) within 1e-4; four decode steps within 1e-3 (bf16 caches
    round alike up to ties); one ``make_train_step`` (numpy frontend for
    vlm and audio) with no kernel of ours, loss and grad norm within
    1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.step import make_prefill_step, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name).smoke().replace(**kw)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    fe = (rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model))
          * 0.02).astype(np.float32) if cfg.frontend_tokens else None
    out = {}
    for d in (dev, torch.device("cpu")):
        params = api.init_params(0, cfg, device=d)
        batch = {"tokens": torch.from_numpy(toks).to(d)}
        if fe is not None:
            batch["frontend"] = fe
        before = _cuda.FLASH.launches
        pre = make_prefill_step(cfg)(params, batch).cpu()
        launched = _cuda.FLASH.launches - before
        cache = api.init_cache(cfg, 2, 8, device=d)
        steps = []
        for t in range(4):
            lg, cache = api.decode_step(params, batch["tokens"][:, t:t + 1],
                                        cache, cfg)
            steps.append(lg.cpu())
        opt = init_adamw(params)
        opt = opt._replace(step=opt.step + 150)
        batch["targets"] = torch.from_numpy(np.roll(toks, -1, 1)).to(d)
        before = _cuda.FLASH.launches
        _, _, m = make_train_step(cfg, cast_bf16=False)(params, opt, batch)
        assert _cuda.FLASH.launches == before
        out[d.type] = (pre, launched, steps, m)
    (pg, ng, sg, mg), (pc, _, sc, mc) = out["cuda"], out["cpu"]
    assert ng == cfg.num_layers
    torch.testing.assert_close(pg, pc, rtol=1e-4, atol=1e-4)
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-4,
                                   atol=0)


# ------------------------------------------- expert parallelism, NCCL
@pytest.fixture
def nccl(dev):
    """An NCCL process group of one process and the host mesh (1, 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    started = init_process_group(dev)
    try:
        assert dist.get_backend() == "nccl"
        yield make_host_mesh()
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("name,full", [("qwen3-moe-30b-a3b", False),
                                       ("granite-moe-3b-a800m", False),
                                       ("qwen3-moe-30b-a3b", True)])
def test_ep_moe_over_nccl_matches_moe_dense(dev, nccl, name, full):
    """``moe_ep`` at dropless capacity (E_pad / top_k) over NCCL's
    all-to-all at world size 1 against ``moe_dense`` on the card, f32
    (TF32 off), within 1e-5 of the output's scale: the smoke configs and
    one full-width qwen3 layer (128 experts, B 1 x S 256); then under
    autograd, the input's and the experts' gradients."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(name) if full else get_arch(name).smoke()
    p = moe.MoE(cfg, device=dev).reset_parameters(
        torch.Generator(device=dev).manual_seed(0))
    S = 256 if full else 32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1 if full else 2, S, cfg.d_model)).astype(np.float32)).to(dev)
    E, K = p.router.shape[-1], cfg.moe.top_k
    x.requires_grad_()
    with moe.count_drops() as drops:
        ep = moe.moe_ep(p, x, cfg, nccl, capacity_factor=E / K)
    dense = moe.moe_dense(p, x, cfg)
    assert drops["dropped"] == 0
    tol = 1e-5 * max(1.0, dense.abs().max().item())
    assert (ep - dense).abs().max().item() <= tol
    g = torch.randn_like(ep)
    ga = torch.autograd.grad((ep * g).sum(), [x, p.w_gate, p.w_down])
    gb = torch.autograd.grad((dense * g).sum(), [x, p.w_gate, p.w_down])
    for a, b in zip(ga, gb):
        assert (a - b).abs().max().item() <= 1e-5 * max(
            1.0, b.abs().max().item())


def test_ep_flash_kernel_at_qwen3_moes_shape(dev):
    """qwen3-moe-30b-a3b's attention, 32 heads over 4 (group size 8), hd
    128, B 2 x S 2048, bf16, on the tensor-core route; the tolerance of
    chip_smoke.py phase 8."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, 2048, 32, 4, 128,
                            seed=8)
    routes = dict(_cuda.FLASH.route_launches)
    got = fk.flash_attention_bhsd(q, k, v, group_size=8)
    torch.cuda.synchronize()
    assert _cuda.FLASH.route_launches["tensor_core_bf16"] == \
        routes["tensor_core_bf16"] + 1
    want = fr.attention_ref(q, k, v, group_size=8)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def test_ep_prefill_step_takes_moe_ep_under_the_host_mesh(dev, nccl):
    """The smoke qwen3 prefill on the card with the host mesh active goes
    through ``moe_ep`` in every layer (choices counted) and through the
    flash kernel once per layer, and equals the prefill with no mesh
    (``moe_dense``) within 1e-4 (f32): 4 tokens, and a capacity of at
    least 4 slots an expert, drop no choice."""
    from repro_torch.configs import get_arch
    from repro_torch.distrib.sharding import set_active_mesh
    from repro_torch.models import api, moe
    from repro_torch.train.step import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    params = api.init_params(0, cfg, device=dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 4))).to(dev)
    pf = make_prefill_step(cfg)
    before = _cuda.FLASH.launches
    set_active_mesh(nccl)
    try:
        with moe.count_drops() as drops:
            got = pf(params, {"tokens": toks})
    finally:
        set_active_mesh(None)
    assert _cuda.FLASH.launches - before == cfg.num_layers
    assert drops["choices"] == cfg.num_layers * 4 * cfg.moe.top_k
    assert drops["dropped"] == 0
    want = pf(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
