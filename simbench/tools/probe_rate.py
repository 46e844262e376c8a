"""Find the probe rate of a served cell once, by a sweep on the card.

    python3 simbench/tools/probe_rate.py --workload matmul_stream.served \
        --rates 10,20,40,80 --seconds 20 --seed 5

Runs the cell's mix at each open-loop rate in turn, in one process, and
prints per rate: probes due, the share of the window's probes still open
at its close, the mean latency of the first and the last third of the
probes (flat when they agree), the p95, and the rows a second. The cell's
rate is then set at four fifths of the highest rate whose backlog stays
flat with the closed-loop tenants running.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from simbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    spec, cell, config, mix = harness.load_cell(ROOT, args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        m = json.loads(json.dumps(mix))
        for t in m["tenants"]:
            if t["loop"] == "open":
                t["rate_per_s"] = rate
        run = harness.Run(spec, cell, config, m, args.seed, "cuda:0")
        out = run.execute(args.seconds, False, time.perf_counter())
        rec = run.record
        lat = sorted(rec.latencies)
        due = np.array([d for d, _s in lat]) - rec.t0
        sec = np.array([s for _d, s in lat])
        open_at_close = float(np.mean(due + sec > rec.t1 - rec.t0)) \
            if len(lat) else 0.0
        third = max(len(sec) // 3, 1)
        print(json.dumps({
            "rate_per_s": rate, "probes": len(lat),
            "open_at_close": open_at_close,
            "first_third_ms": float(np.mean(sec[:third]) * 1e3),
            "last_third_ms": float(np.mean(sec[-third:]) * 1e3),
            "p95_ms": float(np.percentile(sec, 95) * 1e3),
            "lateness_max_ms": float(max(rec.lateness, default=0) * 1e3),
            "configs_per_s": harness.load_reader("configs_per_s")(run),
            "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
