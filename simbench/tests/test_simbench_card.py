"""The benchmark's command on a card, briefly, for each cell: it exits 0,
and its last line is a correct result of the cell's metrics. Marker
``gpu``: skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, *SPEC["command"][1:], "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    else:
        assert any(k.startswith("configs_per_s") and v["value"] > 0
                   for k, v in res["metrics"].items())
