"""Readings of the output check: the program's, and its control's.

    python3 simbench/tools/control.py --workload matmul_stream.sweep \
        --seeds 11,12,13 --seconds 3 [--fault half_batch]

For each seed, runs the cell as the benchmark does (on the card, at the
cell's own size and load, for a short window), reads the check's numbers
for the program's answers, then puts the control in the program's place on
the same sampled rows and reads them again. The control is the plain
reference with every commit time rounded to half precision: an answer that
is close but not exact, which breaks the exactness the configuration
states. With ``--fault``, the fault of that name (``simbench/faults.py``)
is planted under the timed path first, and the program's readings are
those of the broken program. Prints one JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from simbench import check, harness  # noqa: E402
from simbench.faults import FALLBACK_FAULTS, FAULTS  # noqa: E402
from simbench.reference.simulate import simulate_rows  # noqa: E402


def float16_control(run, rows):
    status, cycles = simulate_rows(run.design, rows, dtype="float16")
    return status, cycles, np.zeros(len(rows), np.int64)


ALL_FAULTS = {**FAULTS, **FALLBACK_FAULTS}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--fault", choices=sorted(ALL_FAULTS))
    args = ap.parse_args()
    if args.fault:
        ALL_FAULTS[args.fault](setattr)
    spec, cell, config, mix = harness.load_cell(ROOT, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.Run(spec, cell, config, mix, seed, args.device)
        try:
            out = run.execute(args.seconds, False, time.perf_counter())
        except Exception as exc:        # a run that gives no number fails
            print(json.dumps({"seed": seed, "fault": args.fault,
                              "program_correct": False,
                              "error": repr(exc)[:300]}), flush=True)
            continue
        run.substitute = float16_control
        ctrl = check.judge(run)
        print(json.dumps({
            "seed": seed, "fault": args.fault, "checked": run.checks["checked"],
            "program": out["checks"], "program_correct": out["correct"],
            "control": ctrl["numbers"], "control_correct": ctrl["correct"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
