"""One run of one cell: set-up, the measured window, the output check, the
result line.

The cell names a configuration (``simbench/configs/<config>.json``: the
design function of ``repro_torch.designs`` and its parameters, whose frozen
copy is ``simbench/reference/designs/<function>.py``) and a traffic mix
(``simbench/traffic/<mix>.json``: its ``entry``, which picks the driver in
``simbench/entries/``, and the parameters of ``simbench/traffic.py``); each
is read from the checkout that the run starts in.
Every metric of ``BENCHMARK.json`` is a reader ``simbench/metrics/<name>.py``
with ``read(run)``, which returns a number or None when it finds nothing to
read; a metric split by cells, ``<base>.<cells>``, takes the reader of
``<base>`` unless it has a file of its own. Nothing here knows a cell, a
design or a metric by name.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, guard, timeline, traffic

HERE = Path(__file__).resolve().parent


class Record:
    """What the window sent and got back (thread-safe where tenants write)."""

    def __init__(self):
        self.t0 = self.t1 = 0.0
        self.sent = 0                       # rows sent inside the window
        self.blocks = 0                     # solver blocks of the window
        self.solved = 0                     # distinct rows those solved
        self.latencies: List = []           # open loop: (due, seconds)
        self.lateness: List[float] = []     # open loop: sent minus due
        self.notes: List[str] = []
        self._answers: List = []
        self._lock = threading.Lock()

    def count_sent(self, k: int) -> None:
        with self._lock:
            self.sent += k

    def add_answers(self, D, status, cycles, violated, at,
                    final=None) -> None:
        """``final``: each row's final answer (``check.final_answers``);
        where not given, a REUSED row's cycles, and none for the rest."""
        at = np.broadcast_to(np.asarray(at, float), (len(D),))
        if final is None:
            final = check.final_answers(status, cycles)
        with self._lock:
            self._answers.append((np.asarray(D), np.asarray(status),
                                  np.asarray(cycles), np.asarray(violated),
                                  at.copy(), np.asarray(final)))

    def answers(self):
        """(rows, status, cycles, violated, arrival, final answer) over
        every answer, in the order they were recorded. A row that never
        came back has status -1 and arrival inf."""
        with self._lock:
            parts = list(self._answers)
        if not parts:
            z = np.zeros(0, np.int64)
            return np.zeros((0, 0), np.int64), z, z, z, np.zeros(0), z
        return tuple(np.concatenate([p[i] for p in parts])
                     for i in range(6))

    def answered_in_window(self) -> int:
        at = self.answers()[4]
        return int(np.count_nonzero(at <= self.t1))


def load_reader(name: str):
    """The ``read`` of ``simbench/metrics/<name>.py``, or, where there is no
    such file, of ``simbench/metrics/<name up to its first dot>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run of one cell. ``device`` is where the port runs: the card in a
    measured run; the tests pass ``"cpu"`` (the kernels' plain versions).
    ``root`` is the checkout whose ``simbench/reference/designs/`` holds the
    design's frozen copy."""

    def __init__(self, spec: Dict, cell: Dict, config: Dict, mix: Dict,
                 seed: int, device: str = "cuda", root: Path = HERE.parent):
        self.spec, self.cell, self.config, self.mix = spec, cell, config, mix
        self.seed = int(seed)
        self.device = device
        self.record = Record()
        self.timeline: Optional[timeline.Timeline] = None
        self.gc = timeline.GcClock()
        self.setup_s = self.peak_bytes = None
        self.trace_s = 0.0      # stopping the profiler and reading its trace
        from .reference.simulate import Design
        self.design = Design(config["design"].rsplit(".", 1)[-1],
                             config["params"],
                             Path(root) / "simbench" / "reference" / "designs")
        self._streams = traffic.streams(mix)
        self.rows = traffic.DepthRows(mix["depths"], len(self.design.fifos),
                                      self.seed, len(self._streams))
        # the control (tools/control.py) puts its own answers in the
        # program's place before the check
        self.substitute = None

    # -- what drivers use ---------------------------------------------------
    def program(self):
        mod, fn = self.config["design"].rsplit(".", 1)
        designs = importlib.import_module(f"repro_torch.designs.{mod}")
        return getattr(designs, fn)(**self.config["params"])

    def stream(self, name: str) -> int:
        return self._streams.index(name)

    def arrivals(self, rate_per_s: float) -> np.ndarray:
        return traffic.arrivals(rate_per_s, self.seconds, self.seed)

    def sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the run ------------------------------------------------------------
    def execute(self, seconds: float, trace: bool, t_start: float) -> Dict:
        import torch

        self.seconds = float(seconds)
        on_card = torch.device(self.device).type == "cuda"
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if on_card else "cpu")
        mod = importlib.import_module(f"simbench.entries.{self.mix['entry']}")
        driver = mod.Driver(self)
        prof = None
        try:
            driver.setup()
            self.setup_s = time.perf_counter() - t_start
            with self.gc:
                if trace and on_card:
                    with timeline.profiled() as prof:
                        driver.window(self.seconds)
                    self.trace_s = time.perf_counter() - self.record.t1
                else:
                    driver.window(self.seconds)
            # answers due in the window come back before the trace is read
            driver.drain()
            if on_card:
                self.sync()
                self.peak_bytes = int(torch.cuda.max_memory_allocated(
                    self.device))
        finally:
            driver.close()
        del driver
        if prof is not None:
            t = time.perf_counter()
            self.timeline = timeline.read_trace(prof)
            self.trace_s += time.perf_counter() - t
            del prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        # the output check runs once the program's state is freed
        t = time.perf_counter()
        self.checks = check.judge(self)
        self.reference_s = time.perf_counter() - t
        return self.result(trace, on_card)

    def metrics(self, trace: bool) -> Dict:
        name = self.cell["name"]
        reports = [m for m in self.spec["end_to_end"]
                   if name in m.get("workloads", [name])]
        if trace:
            moved = {m["name"] for m in reports}
            want = [m for m in self.spec["per_layer"]
                    if name in m.get("workloads", [name] if m["moves"]
                                     in moved else [])]
        else:
            want = reports
        out = {}
        for m in want:
            v = load_reader(m["name"])(self)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out

    def result(self, trace: bool, on_card: bool) -> Dict:
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": self.device_kind,
               "count": int(self.cell.get("chips", 1)),
               "memory_peak_bytes": self.peak_bytes or 0}
        if trace and self.timeline is not None:
            dev["busy_s"] = self.timeline.busy_s
            dev["window_s"] = self.timeline.window_s
        rec = self.record
        out = {"correct": self.checks["correct"],
               "attempted": int(rec.sent),
               "failed": int(self.checks["numbers"]["unanswered"]["value"]),
               "metrics": self.metrics(trace),
               "device": dev}
        if trace and self.timeline is not None:
            out["breakdown"] = {
                "device_ops": self.timeline.top_ops(10),
                "idle_gaps": self.timeline.top_idle(10)}
        out["checks"] = self.checks["numbers"]
        return out


def load_cell(root: Path, workload: str):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    mix = json.loads((root / "simbench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    return spec, cell, config, mix


def main(argv, root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="simbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    spec, cell, config, mix = load_cell(root, args.workload)

    import torch
    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"simbench: the cell needs {need} CUDA device(s), this machine "
              f"has {have}", file=sys.stderr)
        return 2
    run = Run(spec, cell, config, mix, args.seed, device="cuda:0", root=root)
    out = run.execute(args.seconds, bool(args.trace), t_start)
    if args.trace and run.timeline is None:
        print("simbench: the profiler saw no device operation in the traced "
              "window", file=sys.stderr)
        return 4
    loaded = guard.jax_loaded()
    if loaded:
        print(f"simbench: JAX or the JAX package was loaded in this process: "
              f"{sorted(loaded)}", file=sys.stderr)
        return 3
    for note in run.record.notes:
        print(f"simbench: {note}", file=sys.stderr)
    rec = run.record
    late = max(rec.lateness, default=0.0)
    print(f"simbench: set-up {run.setup_s:.3f} s, window "
          f"{rec.t1 - rec.t0:.3f} s, {rec.blocks} blocks, open-loop "
          f"generator at most {late * 1e3:.1f} ms late, trace "
          f"{run.trace_s:.3f} s, reference {run.reference_s:.3f} s over "
          f"{run.checks['checked']} rows", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
