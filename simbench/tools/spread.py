"""Spreads of result lines, for setting the bounds of ``BENCHMARK.json``.

    python3 simbench/tools/spread.py runs/a_*.out -- runs/b_*.out

Each file holds one run's standard output, whose last line is its result.
Files before ``--`` are one set, after it another. Prints per metric each
set's median and its spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median;
also the tighter spread that leaves out each set's run farthest from its
median.
"""
import json
import statistics
import sys
from collections import defaultdict


def spread(vals):
    if len(vals) < 2:
        return float("nan")
    q1, _q2, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / statistics.median(vals)


def trimmed(vals):
    med = statistics.median(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    return [v for i, v in enumerate(vals) if i != far]


def load(paths):
    by = defaultdict(list)
    for p in paths:
        with open(p) as fh:
            lines = [ln for ln in fh.read().splitlines() if ln.strip()]
        res = json.loads(lines[-1])
        if not res["correct"]:
            print(f"{p}: correct is false: {res.get('checks')}")
        for k, v in res["metrics"].items():
            by[k].append(v["value"])
    return by


def main(argv):
    sets = [[]]
    for a in argv:
        if a == "--":
            sets.append([])
        else:
            sets[-1].append(a)
    loaded = [load(s) for s in sets if s]
    for name in sorted(set().union(*loaded)):
        row = []
        for by in loaded:
            v = by.get(name, [])
            if v:
                row.append(f"n {len(v)} median {statistics.median(v):.6g} "
                           f"spread {spread(v):.4f} trimmed "
                           f"{spread(trimmed(v)) if len(v) > 2 else 0:.4f}")
        print(f"{name}: " + " | ".join(row))


if __name__ == "__main__":
    main(sys.argv[1:])
