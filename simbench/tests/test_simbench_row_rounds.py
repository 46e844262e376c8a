"""The reader of kernel 1's row-rounds (``kernel1_row_rounds_per_config``):
one small CPU run of each cell under a CPU-only profiler, where the plain
version runs every round over all K rows of a block."""
import importlib
import json

import pytest

from conftest import ROOT, small_run
from simbench import harness, timeline

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_reads_the_row_rounds_of_its_blocks(cell):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    obs.clear()
    run = small_run(cell)
    run.seconds = 1.5
    driver = importlib.import_module(
        f"simbench.entries.{run.mix['entry']}").Driver(run)
    try:
        driver.setup()
        with profile(activities=[ProfilerActivity.CPU]):
            driver.window(run.seconds)
        driver.drain()
    finally:
        driver.close()
    rec = run.record
    run.timeline = timeline.Timeline([], rec.t1 - rec.t0)
    got = [s for s in obs.spans() if s.name == "kernel1.fixpoint"]
    assert got
    for s in got:
        assert s.attrs["row_rounds"] == s.attrs["rows"] * s.attrs["rounds"]
    want = [m["name"] for m in SPEC["per_layer"]
            if m["name"].split(".")[0] == "kernel1_row_rounds_per_config"
            and cell in m["workloads"]]
    assert len(want) == 1
    v = harness.load_reader(want[0])(run)
    assert v is not None and v > 0
    obs.clear()
