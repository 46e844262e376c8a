"""The traffic generator: deterministic for a seed, and no repeated row."""
import numpy as np
import pytest

from simbench import traffic

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("kind", ["grid", "latin"])
def test_grid_rows_repeat_nowhere_and_follow_the_seed(kind):
    spec = {"kind": kind, "lo": 1, "hi": 64}
    a = traffic.DepthRows(spec, 3, BIG, 3)
    rows = [a.take(j, 3000) for j in (0, 1, 2, 0)]
    allr = np.concatenate(rows)
    assert len(np.unique(allr, axis=0)) == len(allr)
    assert allr.min() == 1 and allr.max() == 64
    b = traffic.DepthRows(spec, 3, BIG, 3)
    assert np.array_equal(b.take(0, 3000), rows[0])
    assert np.array_equal(b.take(0, 3000), rows[3])
    c = traffic.DepthRows(spec, 3, BIG + 1, 3)
    assert not np.array_equal(c.take(0, 3000), rows[0])


@pytest.mark.parametrize("kind", ["grid", "latin"])
@pytest.mark.parametrize("n_streams", [2, 3])
def test_the_streams_together_send_the_whole_grid_once(kind, n_streams):
    spec = {"kind": kind, "lo": 3, "hi": 10}
    rows = traffic.DepthRows(spec, 3, BIG, n_streams)
    unit = 8 if kind == "latin" else 1          # a latin group is 8 rows
    share = [(512 // unit - j + n_streams - 1) // n_streams * unit
             for j in range(n_streams)]
    first = [np.concatenate([rows.take(j, 20), rows.take(j, share[j] - 20)])
             for j in range(n_streams)]
    whole = np.concatenate(first)
    assert len(np.unique(whole, axis=0)) == 512 == len(whole)
    assert whole.min() == 3 and whole.max() == 10
    # a stream past its share starts it over, and takes no other's rows
    for j in range(n_streams):
        assert np.array_equal(rows.take(j, share[j]), first[j])


def test_grid_rows_come_in_a_seeded_permutation():
    # not grouped: a stretch of the side's length misses some depths
    spec = {"kind": "grid", "lo": 1, "hi": 64}
    a = traffic.DepthRows(spec, 3, BIG, 1).take(0, 64 * 64)
    groups = a.reshape(64, 64, 3)
    full = sum(len(set(g[:, f])) == 64 for g in groups for f in range(3))
    assert full == 0
    # the share of rows with depth 1 on a FIFO is about 1/64
    assert abs(np.mean(a[:, 1] == 1) - 1 / 64) < 0.01


def test_every_group_of_latin_rows_holds_each_depth_once_per_fifo():
    spec = {"kind": "latin", "lo": 1, "hi": 8}
    rows = traffic.DepthRows(spec, 3, BIG, 2)
    a = np.concatenate([rows.take(0, 20), rows.take(0, 44)])   # 8 groups
    for grp in a.reshape(8, 8, 3):
        for f in range(3):
            assert sorted(grp[:, f]) == list(range(1, 9))


def test_an_unknown_kind_or_too_large_a_grid_is_refused():
    with pytest.raises(ValueError):
        traffic.DepthRows({"kind": "uniform", "lo": 1, "hi": 16}, 3, BIG, 2)
    with pytest.raises(ValueError):
        traffic.DepthRows({"kind": "grid", "lo": 1, "hi": 16}, 25, BIG, 2)


def test_every_seed_offers_the_same_gaps_in_another_order():
    a = traffic.arrivals(40.0, 10.0, BIG)
    b = traffic.arrivals(40.0, 10.0, BIG + 1)
    assert np.array_equal(a, traffic.arrivals(40.0, 10.0, BIG))
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(np.diff(a, prepend=0)),
                       np.sort(np.diff(b, prepend=0)))
    assert a[-1] > 10.0                         # covers the window
    assert abs(np.mean(np.diff(a)) - 1 / 40.0) < 0.05 / 40.0


# the rows of both cells' kinds, as the harness drew them before the box
# kind was added: sha256 of three takes of two streams, first 16 hex digits
PINNED = {"grid": ["f41359cd2982c755", "2dd8f0ea7ab235cd",
                   "7c11213fdbc22d9b", "db36b68e5ed6d58b"],
          "latin": ["e81760cf6c21afa4", "3205d8905708a72f",
                    "4619f74c11ab533a", "6c6b6573ef948c4b"]}


@pytest.mark.parametrize("kind", sorted(PINNED))
@pytest.mark.parametrize("seed", range(4))
def test_grid_and_latin_rows_are_pinned(kind, seed):
    import hashlib
    r = traffic.DepthRows({"kind": kind, "lo": 1, "hi": 64}, 3, seed, 2)
    a = np.concatenate([r.take(0, 3000), r.take(1, 1000), r.take(0, 500)])
    digest = hashlib.sha256(np.ascontiguousarray(a, np.int64).tobytes())
    assert digest.hexdigest()[:16] == PINNED[kind][seed]


# -- box: a depth range per FIFO, drawn through a seeded bijection ---------
def test_box_rows_follow_the_seed():
    spec = {"kind": "box", "lo": [0, 1, 2, 1], "hi": [8, 64, 5, 1]}
    a = traffic.DepthRows(spec, 4, BIG, 2).take(0, 500)
    assert np.array_equal(a, traffic.DepthRows(spec, 4, BIG, 2).take(0, 500))
    assert not np.array_equal(
        a, traffic.DepthRows(spec, 4, BIG + 1, 2).take(0, 500))
    assert len(np.unique(a, axis=0)) == 500
    lo, hi = np.array(spec["lo"]), np.array(spec["hi"])
    assert (a >= lo).all() and (a <= hi).all()
    assert (a.min(axis=0) == lo).all() and (a.max(axis=0) == hi).all()


@pytest.mark.parametrize("n_streams", [1, 2, 3])
def test_a_small_box_drawn_to_its_size_covers_every_row_once(n_streams):
    spec = {"kind": "box", "lo": [1, 0, 3], "hi": [5, 6, 5]}   # 105 rows
    rows = traffic.DepthRows(spec, 3, BIG, n_streams)
    share = [-(-(105 - j) // n_streams) for j in range(n_streams)]
    first = [np.concatenate([rows.take(j, 7), rows.take(j, share[j] - 7)])
             for j in range(n_streams)]
    whole = np.concatenate(first)
    assert len(whole) == 105 == len(np.unique(whole, axis=0))
    grid = np.stack(np.meshgrid(range(1, 6), range(0, 7), range(3, 6),
                                indexing="ij"), -1).reshape(-1, 3)
    assert {tuple(r) for r in whole} == {tuple(r) for r in grid}
    # the streams share no row; one past its share starts it over
    for j in range(n_streams):
        assert np.array_equal(rows.take(j, share[j]), first[j])


def test_a_scalar_bound_stands_for_every_fifo_and_large_boxes_draw_fast():
    import time
    t = time.perf_counter()
    rows = traffic.DepthRows({"kind": "box", "lo": 1, "hi": 8}, 64, BIG, 2)
    a = np.concatenate([rows.take(j, 2048) for j in range(2)])
    assert time.perf_counter() - t < 1.0
    assert a.shape == (4096, 64)
    assert len(np.unique(a, axis=0)) == len(a)
    assert a.min() == 1 and a.max() == 8
    # a box of 2**63 rows and more
    big = traffic.DepthRows({"kind": "box", "lo": 1, "hi": 2 ** 21}, 3, 5, 1)
    b = big.take(0, 256)
    assert len(np.unique(b, axis=0)) == 256 and b.max() <= 2 ** 21


def test_a_box_with_bounds_out_of_order_is_refused():
    with pytest.raises(ValueError):
        traffic.DepthRows({"kind": "box", "lo": [2, 1], "hi": [1, 4]}, 2,
                          BIG, 1)
    with pytest.raises(ValueError):
        traffic.DepthRows({"kind": "box", "lo": -1, "hi": 4}, 2, BIG, 1)
