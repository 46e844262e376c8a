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
