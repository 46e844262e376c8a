"""The output check that decides ``correct``.

The answers judged are what the timed path returned in the window: each
configuration's status, cycle count and violated-constraint count. Two
numbers are compared, each with the limit 0, since every answer of the
simulator is exact:

* ``unanswered``: rows sent in the window that never came back, or came
  back with a service-level failure (cancelled, faulted, timed out,
  rejected);
* ``mismatched``: rows of a sample drawn from the seed (``check_rows`` of
  the mix) whose answer differs from the plain reference's
  (``simbench/reference``), which works each row out again from its own
  frozen copy of the design.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .reference.simulate import REUSED, simulate_rows
from .traffic import rng_for

# statuses a solver gives (reused, deadlock, WAR cycle, violated); the rest
# are the service's terminal failures
SOLVER_STATUSES = (0, 1, 2, 3)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` row positions, drawn from the seed, in order."""
    if n <= k:
        return np.arange(n)
    return np.sort(rng_for(seed, "check").choice(n, size=k, replace=False))


def judge(run) -> Dict:
    D, status, cycles, violated, _at = run.record.answers()
    unanswered = int(np.count_nonzero(~np.isin(status, SOLVER_STATUSES)))
    unanswered += max(int(run.record.sent) - len(status), 0)
    pick = sample(len(status), int(run.mix["check_rows"]), run.seed)
    got = (status[pick], cycles[pick], violated[pick])
    if run.substitute is not None:
        got = run.substitute(run, D[pick])
    ref_status, ref_cycles = simulate_rows(run.design, D[pick])
    bad = ((got[0] != ref_status) | (got[2] != 0)
           | ((ref_status == REUSED) & (got[1] != ref_cycles)))
    numbers = {"unanswered": {"value": unanswered, "limit": 0},
               "mismatched": {"value": int(np.count_nonzero(bad)),
                              "limit": 0}}
    return {"correct": bool(len(pick)) and all(
                v["value"] <= v["limit"] for v in numbers.values()),
            "checked": int(len(pick)), "numbers": numbers}
