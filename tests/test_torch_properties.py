"""PyTorch port: the reference's property-based tests (hypothesis,
``tests/test_properties.py``) on ``repro_torch.core``.

Invariants tested on randomized dataflow programs:
  1. OmniSim == cycle-stepped RTL oracle (functionality + cycle count) for
     arbitrary pipelines with random depths/delays and NB accesses.
  2. Results are independent of the coroutine servicing order (the paper's
     central claim vs OS scheduling).
  3. The decoupled baseline agrees on Type A programs.
  4. Longest-path backends agree on random DAGs.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.property   # opt-in tier: pytest -m property

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core import (Delay, Emit, LightningSim, Program, Read,
                              ReadNB, Write, WriteNB, level_schedule,
                              longest_path_numpy, longest_path_python,
                              simulate, simulate_rtl)


# --------------------------------------------------------------- generators
def build_chain(n_items, stage_delays, depths, nb_flags):
    """A pipeline chain: source -> stage_1 .. stage_k -> sink.

    Stage i forwards with `stage_delays[i]` extra cycles; `nb_flags[i]`
    makes its *write* non-blocking (dropping on full -> Type C)."""
    prog = Program("rand_chain", declared_type="C" if any(nb_flags) else "A")
    chans = [prog.fifo(f"c{i}", depths[i]) for i in range(len(stage_delays) + 1)]

    @prog.module("source")
    def source():
        for i in range(n_items):
            yield Write(chans[0], i + 1)

    def make_stage(s):
        def stage():
            delay = stage_delays[s]
            fwd = 0
            for _ in range(n_items):
                v = yield Read(chans[s])
                if delay:
                    yield Delay(delay)
                if nb_flags[s]:
                    ok = yield WriteNB(chans[s + 1], v)
                    if ok:
                        fwd += 1
                else:
                    yield Write(chans[s + 1], v)
                    fwd += 1
            yield Emit(f"fwd{s}", fwd)
        return stage

    for s in range(len(stage_delays)):
        prog.add_module(f"stage{s}", make_stage(s))

    @prog.module("sink")
    def sink():
        total = 0
        polls = 0
        # NB stages may drop; the sink polls a bounded number of cycles
        for _ in range(n_items * (max(stage_delays, default=0) + 2) + 16):
            ok, v = yield ReadNB(chans[-1])
            polls += 1
            if ok:
                total += v
        yield Emit("total", total)

    return prog


chain_params = st.tuples(
    st.integers(min_value=3, max_value=24),                      # n_items
    st.lists(st.integers(0, 3), min_size=1, max_size=4),         # stage delays
    st.integers(min_value=1, max_value=4),                       # depth seed
    st.lists(st.booleans(), min_size=1, max_size=4),             # nb flags
)


@settings(max_examples=40, deadline=None)
@given(chain_params)
def test_omnisim_matches_rtl_oracle(params):
    n_items, delays, depth, nb = params
    k = len(delays)
    nb = (nb * k)[:k]
    depths = [depth] * (k + 1)
    r1 = simulate(build_chain(n_items, delays, depths, nb))
    r2 = simulate_rtl(build_chain(n_items, delays, depths, nb))
    assert r1.outputs == r2.outputs
    assert r1.cycles == r2.cycles


@settings(max_examples=20, deadline=None)
@given(chain_params, st.integers(min_value=0, max_value=2**31 - 1))
def test_schedule_independence(params, seed):
    n_items, delays, depth, nb = params
    k = len(delays)
    nb = (nb * k)[:k]
    depths = [depth] * (k + 1)
    base = simulate(build_chain(n_items, delays, depths, nb))
    shuf = simulate(build_chain(n_items, delays, depths, nb), shuffle_seed=seed)
    assert base.outputs == shuf.outputs
    assert base.cycles == shuf.cycles


@settings(max_examples=25, deadline=None)
@given(st.integers(3, 40), st.lists(st.integers(0, 3), min_size=1, max_size=4),
       st.integers(1, 5))
def test_typea_three_engines_agree(n_items, delays, depth):
    def build():
        prog = Program("typea_rand", declared_type="A")
        chans = [prog.fifo(f"c{i}", depth) for i in range(len(delays) + 1)]

        @prog.module("source")
        def source():
            for i in range(n_items):
                yield Write(chans[0], i * 3 + 1)

        def mk(s):
            def stage():
                for _ in range(n_items):
                    v = yield Read(chans[s])
                    if delays[s]:
                        yield Delay(delays[s])
                    yield Write(chans[s + 1], v + s)
            return stage

        for s in range(len(delays)):
            prog.add_module(f"st{s}", mk(s))

        @prog.module("sink")
        def sink():
            total = 0
            for _ in range(n_items):
                total += (yield Read(chans[-1]))
            yield Emit("total", total)

        return prog

    r1 = simulate(build())
    r2 = simulate_rtl(build())
    r3 = LightningSim(build()).run()
    assert r1.outputs == r2.outputs == r3.outputs
    assert r1.cycles == r2.cycles == r3.cycles


# ------------------------------------------------------------ graph backends
@st.composite
def random_dag(draw):
    n = draw(st.integers(min_value=1, max_value=120))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    indptr = [0]
    src, wgt = [], []
    for i in range(n):
        k = int(rng.integers(0, min(i, 4) + 1)) if i else 0
        preds = rng.choice(i, size=k, replace=False) if k else []
        for p in preds:
            src.append(int(p))
            wgt.append(int(rng.integers(0, 10)))
        indptr.append(len(src))
    base = rng.integers(0, 5, size=n)
    base[np.diff(indptr) > 0] = 0
    return (np.array(indptr), np.array(src, dtype=np.int64),
            np.array(wgt, dtype=np.int64), base.astype(np.int64))


@settings(max_examples=50, deadline=None)
@given(random_dag())
def test_longest_path_backends_agree(csr):
    indptr, src, wgt, base = csr
    t_py = longest_path_python(indptr, src, wgt, base)
    t_np = longest_path_numpy(indptr, src, wgt, base)
    assert np.array_equal(t_py, t_np)


@settings(max_examples=25, deadline=None)
@given(random_dag())
def test_level_schedule_is_valid(csr):
    indptr, src, _, _ = csr
    level, levels = level_schedule(indptr, src)
    seen = set()
    for group in levels:
        for node in group:
            for k in range(indptr[node], indptr[node + 1]):
                assert src[k] in seen, "pred scheduled after its dependent"
        seen.update(int(x) for x in group)
    assert len(seen) == len(indptr) - 1


# -------------------------------------------------- incremental equivalence
@settings(max_examples=20, deadline=None)
@given(st.integers(4, 30), st.lists(st.integers(0, 2), min_size=1, max_size=3),
       st.integers(1, 4), st.lists(st.integers(1, 12), min_size=2, max_size=2))
def test_incremental_equals_full_resim(n_items, delays, depth, new_depths):
    """For any program and any depth change, incremental re-simulation (or
    its constraint-violation fallback) must equal a from-scratch run."""
    from repro_torch.core import resimulate

    k = len(delays)
    nb = [True] * k
    depths = [depth] * (k + 1)
    base = simulate(build_chain(n_items, delays, depths, nb))
    target = tuple((new_depths * (k + 1))[: k + 1])
    inc = resimulate(base, target)
    full = simulate(build_chain(n_items, delays, list(target), nb))
    assert inc.result.cycles == full.cycles
    assert inc.result.outputs == full.outputs
