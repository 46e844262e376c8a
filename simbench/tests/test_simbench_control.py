"""The output check: sound runs pass it; the control and planted faults of
the timed path fail it. On the CPU lane, at small sizes."""
import json

import numpy as np
import pytest

from conftest import ROOT, small_run
from simbench import check, harness
from simbench.faults import FAULTS
from simbench.reference.simulate import simulate_rows

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _execute(run, seconds=1.5):
    return run.execute(seconds, False, 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _execute(small_run(cell))
    assert out["correct"] is True
    assert out["checks"]["mismatched"] == {"value": 0, "limit": 0}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _float16_control(run, rows):
    """The reference in the program's place, its times in half precision."""
    status, cycles = simulate_rows(run.design, rows, dtype="float16")
    return status, cycles, np.zeros(len(rows), np.int64)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    # at the cell's own configuration: its cycle counts lie past 2048,
    # where half precision is no longer exact
    spec, c, config, mix = harness.load_cell(ROOT, cell)
    run = harness.Run(spec, c, config, dict(mix, check_rows=4), 2 ** 31 + 1,
                      device="cpu")
    rows = run.rows.take(0, 4)
    status, cycles = simulate_rows(run.design, rows)
    run.record.add_answers(rows, status, cycles, np.zeros(4, np.int64),
                           at=0.0)
    run.record.count_sent(4)
    assert check.judge(run)["correct"] is True
    run.substitute = _float16_control
    got = check.judge(run)
    assert got["correct"] is False
    assert got["numbers"]["mismatched"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    run = small_run(cell)
    FAULTS[fault](monkeypatch.setattr)
    out = _execute(run)
    assert out["correct"] is False, out["checks"]
