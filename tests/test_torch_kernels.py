"""PyTorch port, max-plus kernels: the plain PyTorch versions against the
reference's Pallas kernels (CPU interpret mode).

On the CPU the kernel wrappers (``sparse.solve_chains``,
``kernel.maxplus_sweep``) run the plain versions, because their tensors lie
on the CPU; ``tests/test_torch_gpu.py`` holds the hand-written kernels
against those plain versions on a card.  All results are int32 and must
be bit-identical.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import simulate as ref_simulate
from repro.core.dse import _batch_arrays as ref_batch_arrays
from repro.core.dse import _solve_block_numpy as ref_solve_block_numpy
from repro.core.dse import _solve_sparse_jax
from repro.core.incremental import compile_graph as ref_compile_graph
from repro.designs.typea import producer_consumer as ref_producer_consumer
from repro.designs.typea import skynet_like as ref_skynet_like
from repro.kernels.maxplus import kernel as ref_kernel
from repro.kernels.maxplus import ops as ref_ops
from repro.kernels.maxplus import ref as ref_ref
from repro.kernels.maxplus import sparse as ref_sparse
import repro_torch.core.dse as tdse
from repro_torch.core import compile_graph, simulate
from repro_torch.core.graph import segment_length, segment_table
from repro_torch.designs.typea import producer_consumer, skynet_like
from repro_torch.kernels import _cuda
from repro_torch.kernels.maxplus import kernel, ops, ref, sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ dense sweep
def _random_dag_dense(rng, n_real, npad):
    """The reference test's generator (``tests/test_kernels.py``)."""
    a = np.full((npad, npad), int(kernel.NEG), dtype=np.int64)
    base = np.full((npad,), int(kernel.NEG), dtype=np.int64)
    base[:n_real] = rng.integers(0, 4, size=n_real)
    for i in range(1, n_real):
        for p in rng.choice(i, size=min(i, int(rng.integers(0, 3))),
                            replace=False):
            a[i, p] = int(rng.integers(0, 8))
    return a.astype(np.int32), base.astype(np.int32)


def _chains_from_seg_start(seg):
    """``(chain_lo, chain_hi)`` of the contiguous segments of the
    reference's encoding (column j's segment starts at ``seg[j]``)."""
    lo = np.flatnonzero(seg == np.arange(len(seg)))
    hi = np.append(lo[1:], len(seg))
    return torch.from_numpy(lo), torch.from_numpy(hi)


def test_dense_sentinel_matches_reference():
    assert kernel.NEG == int(ref_kernel.NEG) == -(1 << 30)
    assert sparse.NEG == ref_sparse.NEG == -(1 << 29)


@pytest.mark.parametrize("n_real", [5, 60, 128, 250])
def test_longest_path_matches_reference_kernel(n_real):
    rng = np.random.default_rng(n_real)
    npad = ((n_real + ref_kernel.BLK - 1) // ref_kernel.BLK) * ref_kernel.BLK
    a, base = _random_dag_dense(rng, n_real, npad)
    want = np.asarray(ref_ops.longest_path(jnp.asarray(a), jnp.asarray(base),
                                           use_pallas=True, interpret=True))
    got = ops.longest_path(torch.from_numpy(a), torch.from_numpy(base))
    assert np.array_equal(got.numpy(), want)
    # the padding is inert: the unpadded graph gives the same times
    small = ops.longest_path(torch.from_numpy(a[:n_real, :n_real].copy()),
                             torch.from_numpy(base[:n_real].copy()))
    assert np.array_equal(small.numpy(), want[:n_real])
    # npad plain sweeps from base: the reference's fixed-count oracle
    t = torch.from_numpy(base)
    for _ in range(npad):
        t = ref.maxplus_sweep_ref(torch.from_numpy(a), t,
                                  torch.from_numpy(base))
    assert np.array_equal(t.numpy(), np.asarray(ref_ref.longest_path_ref(
        jnp.asarray(a), jnp.asarray(base), npad)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_sweep_matches_reference_kernel(seed):
    rng = np.random.default_rng(seed)
    a, base = _random_dag_dense(rng, 100, 128)
    t = rng.integers(-50, 50, size=128).astype(np.int32)
    want = np.asarray(ref_kernel.maxplus_sweep(
        jnp.asarray(a), jnp.asarray(t), jnp.asarray(base), interpret=True))
    flag = torch.zeros(1, dtype=torch.int32)
    got = kernel.maxplus_sweep(torch.from_numpy(a), torch.from_numpy(t),
                               torch.from_numpy(base), flag)
    assert np.array_equal(got.numpy(), want)
    assert int(flag) == int((want != t).any())


def test_batched_sweep_is_the_per_config_sweep():
    rng = np.random.default_rng(4)
    aK = rng.integers(-8, 8, size=(3, 40, 40)).astype(np.int32)
    aK[rng.random(aK.shape) < 0.6] = kernel.NEG
    tK = rng.integers(-20, 20, size=(3, 40)).astype(np.int32)
    b = rng.integers(-20, 20, size=40).astype(np.int32)
    got = kernel.maxplus_sweep(*(torch.from_numpy(x) for x in (aK, tK, b)))
    for k in range(3):
        want = ref.maxplus_sweep_ref(
            torch.from_numpy(aK[k]), torch.from_numpy(tK[k]),
            torch.from_numpy(b)).numpy()
        assert np.array_equal(got[k].numpy(), want)


def test_finalize_times_matches_reference_and_engine():
    mine = simulate(producer_consumer(n=40, depth=2))
    theirs = ref_simulate(ref_producer_consumer(n=40, depth=2),
                          trace="never")
    got = ops.finalize_times(mine.graph.graph, device="cpu")
    want = np.asarray(ref_ops.finalize_times(theirs.graph.graph,
                                             use_pallas=True, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), mine.graph.graph.times())


def test_sweep_rejects_bad_inputs():
    a = torch.zeros((4, 4), dtype=torch.int32)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernel.maxplus_sweep(a.long(), t, t)
    with pytest.raises(ValueError, match="shape"):
        kernel.maxplus_sweep(a, torch.zeros(3, dtype=torch.int32), t)
    with pytest.raises(ValueError, match="no max-plus kernel"):
        kernel.maxplus_sweep(a.to("meta"), t.to("meta"), t.to("meta"))


@pytest.mark.parametrize("limit", [0, 1, 5, 64, 200, 9226])
def test_check_batches_cover_the_limit_once(limit):
    """The fixpoint loops' flag schedule: 1, 2, 4, ... capped, summing
    to the round limit exactly."""
    batches = list(_cuda.check_batches(limit))
    assert sum(batches) == limit and all(b > 0 for b in batches)
    assert all(b <= _cuda.CHECK_CAP for b in batches)
    want = [min(1 << i, _cuda.CHECK_CAP) for i in range(len(batches))]
    assert batches[:-1] == want[:-1]
    assert batches[-1:] <= want[-1:]


# ---------------------------------------------------------- sparse fixpoint
def _random_segments(rng, npad):
    seg = np.zeros(npad, np.int32)
    lo = 0
    while lo < npad:
        ln = int(rng.integers(1, 17))
        seg[lo:min(lo + ln, npad)] = lo
        lo += ln
    return seg


@pytest.mark.parametrize("K,npad", [(8, 128), (32, 256), (64, 128)])
def test_segmented_cummax_matches_reference_kernel(K, npad):
    """The chain pass's plain version (node-major) against the reference's
    Pallas segmented cummax (config-major)."""
    rng = np.random.default_rng(K + npad)
    seg = _random_segments(rng, npad)
    x = rng.integers(-50, 50, size=(K, npad)).astype(np.int32)
    want = np.asarray(ref_sparse.segmented_cummax(
        jnp.asarray(x), jnp.asarray(seg), interpret=True))
    lo, hi = _chains_from_seg_start(seg)
    got = ref.segmented_cummax_ref(torch.from_numpy(x.T.copy()), lo, hi)
    assert np.array_equal(got.numpy().T, want)


def test_segmented_cummax_max_seg_cap_case():
    rng = np.random.default_rng(5)
    seg = _random_segments(rng, 256)
    x = rng.integers(-50, 50, size=(16, 256)).astype(np.int32)
    lo, hi = _chains_from_seg_start(seg)
    got = ref.segmented_cummax_ref(torch.from_numpy(x.T.copy()), lo, hi)
    for max_seg in (16, 17, None):
        want = np.asarray(ref_sparse.segmented_cummax(
            jnp.asarray(x), jnp.asarray(seg), max_seg=max_seg,
            interpret=True))
        assert np.array_equal(got.numpy().T, want), max_seg


# chain lengths and segment length L: ragged chains; chains shorter than,
# equal to and one longer than L; one-node chains; an empty chain
_SEGMENT_CASES = {
    "ragged": ([5, 17, 1, 33, 8, 64, 3], 8),
    "shorter_equal_longer": ([7, 8, 9], 8),
    "one_node": ([1], 16),
    "one_node_chains_L1": ([1, 1, 2, 1], 1),
    "with_empty_chain": ([4, 0, 9, 16], 4),
    "one_long_chain": ([4610], 72),
    "matmul_stream_like": ([258, 258, 4098, 4610], 72),
}


def _chain_bounds(lens):
    lo = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return lo, lo + np.asarray(lens, np.int64)


@pytest.mark.parametrize("case", sorted(_SEGMENT_CASES))
def test_segment_table_covers_every_node_once_within_its_chain(case):
    """The sparse kernel's work units: every column of every chain in
    exactly one segment of at most L nodes, no segment crossing a chain,
    segments in chain order, each pointing at its chain's first."""
    lens, L = _SEGMENT_CASES[case]
    lo, hi = _chain_bounds(lens)
    seg_lo, seg_hi, seg_first = segment_table(lo, hi, L)
    assert all(a.dtype == np.int32 for a in (seg_lo, seg_hi, seg_first))
    assert len(seg_lo) == sum(-(-n // L) for n in lens)
    cover = np.zeros(sum(lens), np.int64)
    for s, (a, b, f) in enumerate(zip(seg_lo, seg_hi, seg_first)):
        assert 0 < b - a <= L
        cover[a:b] += 1
        c = int(np.searchsorted(hi, a, "right"))      # chain holding a
        assert lo[c] <= a and b <= hi[c]
        assert seg_lo[f] == lo[c] and f <= s
        assert s == 0 or seg_lo[s] >= seg_hi[s - 1]
    assert (cover == 1).all()


@pytest.mark.parametrize("case", sorted(_SEGMENT_CASES))
def test_segment_decomposition_matches_chain_cummax(case):
    """The plain form of the kernel's chain pass (segment maxima, carried
    prefix, walk) equals the per-chain cummax of the plain version and
    the reference's segmented cummax, NEG entries included."""
    lens, L = _SEGMENT_CASES[case]
    lo, hi = _chain_bounds(lens)
    rng = np.random.default_rng(sum(lens) + L)
    x = rng.integers(-50, 50, size=(sum(lens), 6)).astype(np.int32)
    x[rng.random(x.shape) < 0.3] = sparse.NEG
    table = [torch.from_numpy(a) for a in segment_table(lo, hi, L)]
    got = ref.segment_cummax_ref(torch.from_numpy(x), *table)
    want = ref.segmented_cummax_ref(torch.from_numpy(x), torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    assert torch.equal(got, want)
    seg_start = np.repeat(lo, lens).astype(np.int32)
    theirs = ref_sparse.segmented_cummax_ref(jnp.asarray(x.T),
                                             jnp.asarray(seg_start))
    assert np.array_equal(got.numpy().T, np.asarray(theirs))


@pytest.mark.parametrize("lens,want", [([1], 16), ([258, 4610], 48),
                                       ([514] * 10, 16), ([4098] * 26, 48),
                                       ([20000], 96), ([], 16)])
def test_segment_length_is_about_the_root_of_the_longest_chain(lens, want):
    assert segment_length(np.asarray(lens, np.int64)) == want


def test_exported_segment_table_is_the_chains_cut_at_segment_length():
    g = compile_graph(simulate(skynet_like(items=16, depth=4)).graph)
    arr = tdse._sparse_arrays(tdse._batch_arrays(g), "cpu")
    lo, hi = arr.chain_lo.numpy(), arr.chain_hi.numpy()
    table = segment_table(lo, hi, segment_length(hi - lo))
    for got, want in zip((arr.seg_lo, arr.seg_hi, arr.seg_first), table):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_solve_chains_matches_reference_sparse_and_numpy_solvers():
    """End-to-end sparse solve (plain version) vs the reference's Pallas
    ``solve_chains`` and its numpy Gauss-Seidel solver, WAR edges active:
    same converged mask, same (n, K) times on converged rows."""
    rb = ref_simulate(ref_skynet_like(items=16, depth=4), trace="never")
    ref_g = ref_compile_graph(rb.graph)
    ref_ba = ref_batch_arrays(ref_g)
    port_g = compile_graph(simulate(skynet_like(items=16, depth=4)).graph)
    port_ba = tdse._batch_arrays(port_g)
    Db = np.random.default_rng(2).integers(
        1, 9, size=(8, len(rb.depths))).astype(np.int64)
    t_np, conv_np, _ = ref_solve_block_numpy(ref_ba, Db)
    t_jx, conv_jx, _ = _solve_sparse_jax(ref_g, ref_ba, Db)
    t_pt, conv_pt, _ = tdse._solve_sparse_cuda(port_g, port_ba, Db, "cpu")
    conv_pt = conv_pt.numpy()
    assert (conv_np == conv_pt).all() and (conv_jx == conv_pt).all()
    cols = np.flatnonzero(conv_np)
    assert len(cols)
    assert (np.asarray(t_np)[:, cols] == t_pt.numpy()[:, cols]).all()
    assert (t_jx[:, cols] == t_pt.numpy()[:, cols]).all()


def test_solve_chains_flags_a_war_cycle():
    """Burst ping-pong with both channels at depth 1: the row diverges
    past the acyclic bound and is not converged; a roomy row converges."""
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

    g = compile_graph(simulate(prog).graph)
    ba = tdse._batch_arrays(g)
    _, conv, _ = tdse._solve_sparse_cuda(g, ba, np.array([[1, 1], [8, 8]]),
                                         "cpu")
    assert conv.tolist() == [False, True]


def test_solve_chains_rejects_bad_inputs():
    g = compile_graph(simulate(producer_consumer(n=8, depth=2)).graph)
    arr = tdse._sparse_arrays(tdse._batch_arrays(g), "cpu")
    with pytest.raises(ValueError, match="int32"):
        sparse.solve_chains(arr, torch.ones((2, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="to_device"):
        sparse.solve_chains(arr._replace(cw=arr.cw.long()),
                            torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="no max-plus kernel"):
        sparse.solve_chains(sparse.to_device(arr, "meta"),
                            torch.ones((2, 1), dtype=torch.int32,
                                       device="meta"))


# --------------------------------------------------------------- the build
def test_kernel_sources_and_build_dir():
    """Every kernel is a CUDA source of the package, built for sm_90a into
    a directory that git ignores, under a name that changes with its
    source.  The sources include no header of their own: the digest
    hashes only the ``.cu`` file, so a ``csrc/*.cuh`` must join it
    first."""
    assert not list(_cuda.CSRC.glob("*.cuh"))
    for lib in _cuda.LIBS:
        assert lib.source.exists(), lib.source
        text = lib.source.read_text()
        assert "extern \"C\"" in text
        assert '#include "' not in text
        assert lib.target().parent == _cuda.BUILD_DIR
        assert lib.target().name.startswith(f"lib{lib.name}-")
    assert "arch=compute_90a,code=sm_90a" in _cuda.ARCH_FLAGS
    assert _cuda.BUILD_DIR == Path(ROOT) / "build" / "kernels"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert _cuda.SPARSE.launches >= 0 and _cuda.DENSE.launches >= 0
    assert set(_cuda.FLASH.route_launches) == {"tensor_core_bf16", "fma_f32"}
