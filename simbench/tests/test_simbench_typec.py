"""A Type C cell that the repository does not hold: its BENCHMARK.json,
configuration, frozen copy and box of depths are data files in a checkout
of their own, and the harness takes them as they are. On the CPU lane."""
import json
import shutil

import numpy as np
import pytest

from conftest import ROOT
from simbench import check, harness
from simbench.faults import FALLBACK_FAULTS
from simbench.reference.simulate import simulate_rows

# fig4_ex5 at 1 100 items reads past 2 048 cycles, where half precision is
# no longer exact; depth 0 on either FIFO deadlocks the design. The host
# solver ("numpy") stands in for kernel 1, whose plain version is slow at
# this depth of chain
BOX = {"kind": "box", "lo": [0, 1], "hi": [4, 4]}
MIXES = {
    "box_sweep": {"entry": "resimulate_batch", "rows": 16,
                  "call": {"backend": "numpy"}, "depths": BOX,
                  "check_rows": 16},
    "box_served": {"entry": "sweep_service",
                   "service": {"block": 16, "shards": 1, "mode": "thread",
                               "backend": "numpy"},
                   "depths": BOX,
                   "tenants": [{"name": "bulk", "loop": "closed",
                                "rows": 16}],
                   "check_rows": 16}}


def _checkout(tmp_path, mix: str):
    sb = tmp_path / "simbench"
    for d in ("configs", "traffic", "reference/designs"):
        (sb / d).mkdir(parents=True)
    shutil.copy(ROOT / "simbench/reference/designs/fig4_ex5.py",
                sb / "reference/designs/fig4_ex5.py")
    (sb / "configs/fig4_ex5_small.json").write_text(json.dumps(
        {"design": "paper.fig4_ex5", "params": {"n": 1100}}))
    (sb / f"traffic/{mix}.json").write_text(json.dumps(MIXES[mix]))
    cell = f"fig4_ex5_small.{mix}"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "fig4_ex5_small",
                     "file": "simbench/configs/fig4_ex5_small.json"}],
        "workloads": [{"name": cell, "config": "fig4_ex5_small",
                       "traffic": mix, "chips": 1}],
        "end_to_end": [{"name": "configs_per_s", "unit": "configs/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}))
    spec, c, config, m = harness.load_cell(tmp_path, cell)
    return harness.Run(spec, c, config, m, 2 ** 31 + 77, device="cpu",
                       root=tmp_path)


def _float16_control(run, rows):
    return simulate_rows(run.design, rows, dtype="float16")


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_type_c_cell_reads_correct_and_its_control_does_not(tmp_path, mix):
    run = _checkout(tmp_path, mix)
    out = run.execute(1.5, False, 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["mismatched"]["value"] == 0
    assert set(out["metrics"]) == {"configs_per_s", "setup_s"}
    D, status, _c, _v, _at, final = run.record.answers()
    # the sample holds rows the solver reused, rows it handed to the
    # fallback, and deadlocks
    pick = check.sample(len(status), 16, run.seed)
    assert (status[pick] == 0).any() and (status[pick] != 0).any()
    assert (final[pick] == check.DEADLOCKED).any()
    assert (final > 2048).any()
    run.substitute = _float16_control
    assert check.judge(run)["numbers"]["mismatched"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FALLBACK_FAULTS))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_fallback_fault_is_not_correct(tmp_path, mix, fault, monkeypatch):
    run = _checkout(tmp_path, mix)
    FALLBACK_FAULTS[fault](monkeypatch.setattr)
    out = run.execute(1.5, False, 0.0)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["mismatched"]["value"] > 0


def test_final_answers_read_the_fallback_only_off_the_reused_rows():
    class Full:
        def __init__(self, deadlock, cycles):
            self.deadlock, self.cycles = deadlock, cycles

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError("a REUSED row's result was read")

    status = np.array([0, 1, 3, 2, 1, 4])
    cycles = np.array([70, -1, 90, -1, -1, -1])
    results = [Untouchable(), Full(True, 12), Full(False, 95), None,
               Full(False, 80), None]
    got = check.final_answers(status, cycles, results)
    assert got.tolist() == [70, check.DEADLOCKED, 95, check.NO_ANSWER, 80,
                            check.NO_ANSWER]
    assert check.final_answers(status, cycles).tolist() == \
        [70] + [check.NO_ANSWER] * 5
