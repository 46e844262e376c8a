"""The benchmark's metric arithmetic, on synthetic inputs."""
import numpy as np
import pytest

from simbench import harness, timeline
from simbench.costs import kernel1_bytes
from simbench.reference.simulate import Design


class _Run:
    """The parts of a harness Run that the readers read."""

    def __init__(self, tl=None, blocks=0, solved=0):
        self.timeline = tl
        self.record = harness.Record()
        self.record.blocks, self.record.solved = blocks, solved
        self.design = Design("matmul_stream", {"m": 2, "k": 2, "n": 2})
        self.device_kind = "NVIDIA H100 80GB HBM3"
        self.gc = timeline.GcClock()
        self.peak_bytes = None
        self.setup_s = 1.5


def test_idle_share_is_the_uncovered_part_of_the_window():
    # two overlapping kernels and one apart: busy 0.1-0.3 and 0.5-0.6
    tl = timeline.Timeline([("k1", 0.1, 0.2), ("k2", 0.15, 0.3),
                            ("k1", 0.5, 0.6)], 1.0)
    assert tl.busy_s == pytest.approx(0.3)
    assert tl.idle == [(0.0, 0.1), (0.3, 0.5), (0.6, 1.0)]
    run = _Run(tl, blocks=4, solved=100)
    assert harness.load_reader("device_idle_pct")(run) == pytest.approx(70.0)
    assert harness.load_reader("driver_host_ms_per_block")(run) == \
        pytest.approx(175.0)
    # overlapping kernels never count twice, so busy never passes the window
    tl = timeline.Timeline([("a", 0.0, 1.0), ("b", 0.0, 1.0)], 1.0)
    assert tl.busy_s == pytest.approx(1.0)


def test_kernel1_readers_take_only_its_three_kernels():
    tl = timeline.Timeline([("segment_max_kernel<4>", 0.0, 0.1),
                            ("segment_walk_kernel<4>", 0.1, 0.3),
                            ("cross_pass_kernel<4>", 0.3, 0.6),
                            ("at::native::reduce_kernel", 0.6, 0.9)],
                           1.0)
    run = _Run(tl, blocks=2, solved=300)
    us = harness.load_reader("kernel1_us_per_config")(run)
    assert us == pytest.approx(0.6 / 300 * 1e6)
    pct = harness.load_reader("kernel1_roofline_pct")(run)
    want = 100 * kernel1_bytes(run.design, 300, 2) / 3.35e12 / 0.6
    assert pct == pytest.approx(want) and 0 < pct < 100
    # nothing to read: no trace, or no kernel-1 kernel in it
    assert harness.load_reader("kernel1_roofline_pct")(_Run()) is None
    none = _Run(timeline.Timeline([("x", 0, 1)], 1.0), 1, 1)
    assert harness.load_reader("kernel1_us_per_config")(none) is None
    # a card without a published peak gives no roofline share
    none.timeline, none.device_kind = tl, "some other card"
    assert harness.load_reader("kernel1_roofline_pct")(none) is None


def test_read_once_bytes_follow_the_design_sizes():
    d = Design("matmul_stream", {"m": 16, "k": 16, "n": 16})
    assert (d.n_nodes, d.n_reads, d.n_writes) == (9224, 4608, 4608)
    graph = 4 * (2 * 9224 + 4 * 4608 + 3 * 4608 + 2 * 3 + 2 * 4)
    assert kernel1_bytes(d, 1024, 1) == graph + 1024 * 4 * (3 + 9224)
    assert kernel1_bytes(d, 2048, 2) == 2 * kernel1_bytes(d, 1024, 1)


def test_p95_covers_every_probe_and_rate_counts_the_window():
    run = _Run()
    lat = np.linspace(0.1, 1.0, 100)
    run.record.latencies = [(i, x) for i, x in enumerate(lat)]
    assert harness.load_reader("query_p95_ms")(run) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert harness.load_reader("query_p95_ms")(_Run()) is None
    rec = run.record
    rec.t0, rec.t1 = 10.0, 12.0
    D = np.ones((4, 3), np.int64)
    z = np.zeros(4, np.int64)
    rec.add_answers(D, z, z, z, at=np.array([10.5, 11.0, 12.0, 12.5]))
    assert harness.load_reader("configs_per_s")(run) == pytest.approx(1.5)


def test_gc_clock_counts_full_collections_only():
    import gc
    run = _Run()
    with run.gc:
        gc.collect(0)
        assert run.gc.full_passes == 0
        gc.collect(2)
    assert run.gc.full_passes == 1
    assert harness.load_reader("gc_full_ms")(run) >= 0.0


def test_a_metric_split_by_cells_takes_its_base_reader():
    tl = timeline.Timeline([("k", 0.0, 0.25)], 1.0)
    run = _Run(tl, blocks=1, solved=1)
    assert harness.load_reader("device_idle_pct.served")(run) == \
        harness.load_reader("device_idle_pct")(run) == pytest.approx(75.0)


def test_idle_gaps_are_named_by_the_host_operation_inside_them():
    # device busy 0.2-0.4; idle 0-0.2 (middle 0.1) and 0.4-1.0 (middle 0.7)
    host = [("aten::unique", 0.0, 0.15), ("cudaLaunchKernel", 0.05, 0.12),
            ("cudaStreamSynchronize", 0.3, 0.45)]
    tl = timeline.Timeline([("k", 0.2, 0.4)], 1.0, host)
    assert tl.top_idle() == [[timeline.HOST_CODE, pytest.approx(0.6)],
                             ["cudaLaunchKernel", pytest.approx(0.2)]]
    # an outer operation that started earlier still names the gap
    tl = timeline.Timeline([("k", 0.2, 0.4)], 1.0,
                           [("aten::unique", 0.0, 0.9),
                            ("cudaLaunchKernel", 0.01, 0.02)])
    assert tl.top_idle() == [["aten::unique", pytest.approx(0.8)]]
    assert timeline.Timeline([("k", 0.0, 1.0)], 1.0).top_idle() == []
    assert timeline.short_name(
        "void (anonymous namespace)::cross_pass_kernel<4>(int*, int)") == \
        "cross_pass_kernel<4>"
