"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version on the same inputs, and the device lanes against the
port's exact host oracle.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one: a CUDA kernel has no CPU mode, and its plain version is what the CPU
tests hold against the reference.  This file imports only the port (no
``jax``, no ``repro``), so it runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core.dse as tdse
from repro_torch.core import compile_graph, resimulate_batch, simulate
from repro_torch.designs.paper import fig4_ex5
from repro_torch.designs.typea import (merge_sort_staged, producer_consumer,
                                       skynet_like)
from repro_torch.kernels import _cuda
from repro_torch.kernels.maxplus import kernel, ops, ref

pytestmark = pytest.mark.gpu


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
