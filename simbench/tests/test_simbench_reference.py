"""The plain reference against the port's CPU lane, at small sizes, and the
harness's import guard and refusals."""
import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from simbench import guard
from simbench.reference.simulate import DEADLOCK, REUSED, Design, simulate

CASES = [("matmul_stream", {"m": 4, "k": 4, "n": 4}),
         ("matmul_stream", {"m": 3, "k": 5, "n": 2}),
         ("matmul_stream", {"m": 2, "k": 8, "n": 3}),
         ("matmul_stream", {"m": 5, "k": 2, "n": 6})]


@pytest.mark.parametrize("name,params", CASES)
def test_reference_agrees_with_the_port_cpu_lane(name, params):
    from repro_torch.core import resimulate_batch
    from repro_torch.core import simulate as port_simulate
    from repro_torch.designs import typea

    prog = getattr(typea, name)(**params)
    d = Design(name, params)
    assert d.fifos == tuple(f.name for f in prog.fifos)
    base = port_simulate(prog)
    assert len(base.graph.graph.nodes) == d.n_nodes
    assert simulate(d, prog.depths()) == (REUSED, base.cycles)
    rng = np.random.default_rng(3)
    D = rng.integers(1, 9, size=(32, len(d.fifos)))
    out = resimulate_batch(base, D, backend="cuda", device="cpu")
    ref = [simulate(d, row) for row in D]
    assert list(out.status) == [s for s, _c in ref]
    assert list(out.cycles) == [c for _s, c in ref]
    assert not out.violated.any()


def test_reference_finds_a_deadlock_and_the_control_rounds():
    d = Design("matmul_stream", {"m": 16, "k": 16, "n": 16})
    assert simulate(d, [0, 1, 1]) == (DEADLOCK, -1)
    exact = simulate(d, [1, 1, 1])[1]
    half = simulate(d, [1, 1, 1], dtype="float16")[1]
    assert exact > 2048 and half != exact


def test_import_guard_compares_whole_top_level_names():
    assert guard.jax_loaded(["repro_torch", "repro_torch.core",
                             "jaxtyping", "reprox", "numpy"]) == set()
    assert guard.jax_loaded(["repro.core.dse", "jax.numpy", "flax",
                             "jaxlib.xla_client"]) == \
        {"repro", "jax", "flax", "jaxlib"}


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from simbench import harness, check, timeline, traffic\n"
            "from simbench.entries import resimulate_batch, sweep_service\n"
            "import repro_torch.core, repro_torch.sweep\n"
            "from simbench.guard import jax_loaded\n"
            "print(sorted(jax_loaded()))" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run(
        [sys.executable, *cmd[1:], "--workload", "matmul_stream.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
