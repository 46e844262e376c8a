"""Shared set-up of the benchmark's own tests.

Run from the repository root:

    PYTHONPATH=src python -m pytest -q simbench/tests             # CPU
    PYTHONPATH=src python -m pytest -q -m gpu simbench/tests      # on a card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small versions of the benchmarked designs, run on the CPU lane
SMALL = {"typea.matmul_stream": {"m": 4, "k": 4, "n": 4}}


@pytest.fixture
def card():
    """Skips the test on a machine without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def small_run(cell_name: str, seed: int = 2 ** 31 + 7, rows: int = 64):
    """A harness Run of ``cell_name`` on the CPU lane at a small size, with
    the cell's own traffic mix but ``rows`` rows a request at most."""
    from simbench import harness
    spec, cell, config, mix = harness.load_cell(ROOT, cell_name)
    config = dict(config, params=SMALL[config["design"]])
    mix = dict(mix)
    if "rows" in mix:
        mix["rows"] = min(mix["rows"], rows)
    if "tenants" in mix:
        mix["tenants"] = [dict(t, rows=min(t["rows"], rows))
                          for t in mix["tenants"]]
    return harness.Run(spec, cell, config, mix, seed, device="cpu")
