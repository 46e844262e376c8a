"""PyTorch port, the last public names of ``repro.core``:
``longest_path_python`` (the straight-line longest-path oracle) and
``Program.static_trace`` (which only raises), against the reference.

Integer host code: every answer must equal the reference's exactly.
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.designs.paper import PAPER_DESIGNS
from repro_torch.designs.typea import matmul_stream, merge_sort_staged, \
    skynet_like


def test_the_port_has_every_public_name_of_the_reference_core():
    assert set(R.__all__) <= set(T.__all__)
    assert "longest_path_python" in T.__all__


DESIGNS = {
    "skynet_like": lambda: skynet_like(items=24, depth=4),
    "matmul_stream": lambda: matmul_stream(),
    "merge_sort_staged": lambda: merge_sort_staged(4),
    "fig4_ex5": lambda: PAPER_DESIGNS["fig4_ex5"](n=48),
}


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_longest_path_python_on_designs(name):
    """On a design's simulation graph: the port's oracle equals the
    reference's on the same CSR, the vectorized backend and the recorded
    times.  The graph is the generator engine's, whose creation order is
    topological, as the oracle assumes (compiled replay numbers its nodes
    chain-major)."""
    res = T.simulate(DESIGNS[name](), trace="never")
    g = res.graph.graph
    csr = g.to_csr()
    got = T.longest_path_python(*csr)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, R.longest_path_python(*csr))
    np.testing.assert_array_equal(got, T.longest_path_numpy(*csr))
    np.testing.assert_array_equal(got, g.times())


def _random_dag(seed):
    """The reference property test's DAG generator (its ``random_dag``),
    on a numpy seed: up to 4 predecessors a node, weights 0-9, base times
    only on sources."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 121))
    indptr, src, wgt = [0], [], []
    for i in range(n):
        k = int(rng.integers(0, min(i, 4) + 1)) if i else 0
        for p in (rng.choice(i, size=k, replace=False) if k else []):
            src.append(int(p))
            wgt.append(int(rng.integers(0, 10)))
        indptr.append(len(src))
    base = rng.integers(0, 5, size=n)
    base[np.diff(indptr) > 0] = 0
    return (np.array(indptr), np.array(src, dtype=np.int64),
            np.array(wgt, dtype=np.int64), base.astype(np.int64))


@pytest.mark.parametrize("seed", range(12))
def test_longest_path_python_on_random_dags(seed):
    csr = _random_dag(seed)
    got = T.longest_path_python(*csr)
    np.testing.assert_array_equal(got, R.longest_path_python(*csr))
    np.testing.assert_array_equal(got, T.longest_path_numpy(*csr))


def test_longest_path_python_leaves_its_inputs_alone():
    csr = _random_dag(3)
    copies = [a.copy() for a in csr]
    T.longest_path_python(*csr)
    for a, b in zip(csr, copies):
        np.testing.assert_array_equal(a, b)


def test_static_trace_raises_as_the_reference_does():
    prog = T.Program("p")
    ref = R.Program("p")
    with pytest.raises(NotImplementedError) as got:
        prog.static_trace()
    with pytest.raises(NotImplementedError) as want:
        ref.static_trace(max_ops_per_module=10)
    assert str(got.value) == str(want.value) == \
        "use core.taxonomy.classify(program)"
