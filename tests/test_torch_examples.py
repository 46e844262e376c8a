"""PyTorch port, the examples (``examples_torch/``) on the CPU, held line
for line against the reference's (``examples/``).

Each example runs as a subprocess in its own ``tmp_path`` with
``PYTHONPATH=src`` and ``--device cpu`` where it takes a device:

- every ``.py`` in ``examples_torch/`` is registered in
  :data:`EXAMPLE_ARGS` with its CI-sized arguments, and each runs to exit
  0;
- ``quickstart``, ``fifo_sizing_dse`` and ``pipeline_perfsim`` run beside
  the reference's copy in one directory, and print the same lines once
  the clock readings (``… ms``, the speed-up columns) and the sweep
  service's two thread-timed counters (its block count and cache hit
  rate) are masked; ``chip_smoke.py``'s parser of ``fifo_sizing_dse``'s
  clock-free numbers (phase 25 (a)) reads the same values from both;
- ``pipeline_perfsim`` again, in a directory that holds one hand-written
  dry-run record of qwen2.5-14b train_4k: both packages take the record's
  tick costs and print the same table;
- ``train_smollm`` logs the losses of ``repro_torch.launch.train.main``
  called in this process with the same arguments.  At ``--steps 2`` its
  ``--log-every 20`` logs no loss, so that comparison runs 20 steps; the
  reference's copy fails (``tests/test_docs.py``, a fault of the
  reference) and is not run;
- without a card, ``fifo_sizing_dse`` and ``train_smollm`` at their
  default ``--device cuda`` exit non-zero naming the missing device, and
  ``fifo_sizing_dse`` prints nothing first.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(REPO, "examples_torch")
REFERENCE = os.path.join(REPO, "examples")
TIMEOUT = 300

# Every file in examples_torch/ must be registered here (enforced below)
# with the arguments that make it a CI-sized run on the CPU.
EXAMPLE_ARGS = {
    "quickstart.py": [],
    "fifo_sizing_dse.py": ["--device", "cpu"],
    "pipeline_perfsim.py": [],
    "train_smollm.py": ["--steps", "2", "--device", "cpu"],
}
# the examples whose output is compared with the reference's
COMPARED = ("quickstart.py", "fifo_sizing_dse.py", "pipeline_perfsim.py")

# clock readings, then the service's thread-timed counters
MASKS = (
    (re.compile(r"\s*-?\d+(\.\d+)?\s?ms\b"), " <ms>"),
    (re.compile(r"\d+(\.\d+)?x faster"), "<x> faster"),
    (re.compile(r"\s+\d+(\.\d+)?x$"), " <x>"),
    (re.compile(r"cache hit rate \d+(\.\d+)?"), "cache hit rate <rate>"),
    (re.compile(r", \d+ blocks,"), ", <n> blocks,"),
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep * bool(env.get("PYTHONPATH")) \
        + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    # the in-process comparison's thread count, so both sum alike
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return env


def _run(script, args, cwd):
    return subprocess.run([sys.executable, script, *args], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT)


def _masked(text):
    lines = []
    for line in text.splitlines():
        for pattern, repl in MASKS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


def _ok(proc, what):
    assert proc.returncode == 0, (
        f"{what} failed:\n--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}")
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (port run, reference run or None)}, each pair in one
    directory."""
    out = {}
    for name in sorted(EXAMPLE_ARGS):
        cwd = tmp_path_factory.mktemp(name[:-3])
        port = _run(os.path.join(PORT, name), EXAMPLE_ARGS[name], cwd)
        ref = (_run(os.path.join(REFERENCE, name), [], cwd)
               if name in COMPARED else None)
        out[name] = (port, ref)
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_port_example_is_registered():
    on_disk = sorted(f for f in os.listdir(PORT) if f.endswith(".py"))
    assert on_disk == sorted(EXAMPLE_ARGS)
    # one port example for each of the reference's
    assert on_disk == sorted(f for f in os.listdir(REFERENCE)
                             if f.endswith(".py"))


@pytest.mark.parametrize("name", sorted(EXAMPLE_ARGS))
def test_port_example_runs(runs, name):
    _ok(runs[name][0], f"examples_torch/{name}")


@pytest.mark.parametrize("name", COMPARED)
def test_port_example_prints_the_references_lines(runs, name):
    port, ref = runs[name]
    got = _masked(_ok(port, f"examples_torch/{name}"))
    want = _masked(_ok(ref, f"examples/{name}"))
    assert got == want
    assert len(got) >= 10


def test_chip_smokes_parser_reads_the_same_numbers(runs):
    """Phase 25 (a) compares these values between its card and CPU runs;
    here they are the reference's."""
    smoke = _chip_smoke()
    port, ref = runs["fifo_sizing_dse.py"]
    got = smoke.dse_numbers(port.stdout.splitlines())
    assert got == smoke.dse_numbers(ref.stdout.splitlines())
    assert sorted(got) == sorted(smoke.DSE_NUMBERS)
    assert len(got["act 1 (depth, cycles, method)"]) == 5
    for _, start in smoke.DSE_ACT_ENDS:
        assert sum(line.startswith(start)
                   for line in port.stdout.splitlines()) == 1


def test_pipeline_perfsim_takes_a_dry_run_records_tick_costs(tmp_path):
    records = tmp_path / "reports" / "dryrun"
    records.mkdir(parents=True)
    rec = {"status": "ok", "roofline": {"compute_s": 0.0123,
                                        "memory_s": 0.4567,
                                        "collective_s": 0.0891}}
    with open(records / "qwen2.5-14b__train_4k__sp.json", "w") as f:
        json.dump(rec, f)
    port = _ok(_run(os.path.join(PORT, "pipeline_perfsim.py"), [],
                    tmp_path), "examples_torch/pipeline_perfsim.py")
    ref = _ok(_run(os.path.join(REFERENCE, "pipeline_perfsim.py"), [],
                   tmp_path), "examples/pipeline_perfsim.py")
    head = "tick costs from qwen2.5-14b train_4k dry-run: "
    assert port.startswith(head) and ref.startswith(head)
    assert _masked(port) == _masked(ref)
    # --records DIR reads the same record from elsewhere
    moved = _ok(_run(os.path.join(PORT, "pipeline_perfsim.py"),
                     ["--records", str(records)], REPO),
                "examples_torch/pipeline_perfsim.py --records")
    assert _masked(moved) == _masked(port)


def test_train_smollm_logs_the_launchers_losses(tmp_path):
    from repro_torch.launch import train

    out = _ok(_run(os.path.join(PORT, "train_smollm.py"),
                   ["--steps", "20", "--device", "cpu"], tmp_path),
              "examples_torch/train_smollm.py")
    logged = re.findall(r"^step\s+\d+ loss=\S+ gnorm=\S+ lr=\S+", out,
                        re.M)
    got = train.main(["--arch", "smollm-135m", "--smoke", "--steps", "20",
                      "--batch", "8", "--seq", "128", "--ckpt-every", "100",
                      "--log-every", "20", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "in_process")])
    want = [f"step {h['step']:6d} loss={h['loss']:.4f} "
            f"gnorm={h['grad_norm']:.3f} lr={h['lr']:.2e}"
            for h in got["history"] if h["step"] % 20 == 0]
    assert logged == want and len(want) == 1
    assert (tmp_path / "checkpoints" / "smollm-135m"
            / "step_000000000020").is_dir()


@pytest.mark.parametrize("name", ["fifo_sizing_dse.py", "train_smollm.py"])
def test_without_a_card_the_default_device_fails(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    args = ["--steps", "1"] if name == "train_smollm.py" else []
    proc = _run(os.path.join(PORT, name), args, tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    if name == "fifo_sizing_dse.py":
        assert proc.stdout == ""
