"""The output check that decides ``correct``.

The answers judged are what the timed path returned in the window. A row's
final answer is a cycle count or "deadlock": for a row the solver reused
(REUSED), its cycle count; for a row it could not (DEADLOCK, CYCLE,
VIOLATED), the verdict of the exact full re-simulation that the program
falls back to (its deadlock flag, else its cycle count). A solver verdict
that comes back without that re-simulation has no final answer. Two
numbers are compared, each with the limit 0, since every answer of the
simulator is exact:

* ``unanswered``: rows sent in the window that never came back, or came
  back with a service-level failure (cancelled, faulted, timed out,
  rejected);
* ``mismatched``: rows of a sample drawn from the seed (``check_rows`` of
  the mix) whose final answer differs from the plain reference's
  (``simbench/reference``), which works each row out again from its own
  frozen copy of the design, or that have no final answer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .reference.simulate import DEADLOCK, LIVELOCK, REUSED, simulate_rows
from .traffic import rng_for

# statuses a solver gives (reused, deadlock, WAR cycle, violated); the rest
# are the service's terminal failures
SOLVER_STATUSES = (0, 1, 2, 3)
# a final answer is a cycle count (at least 1) or one of these
DEADLOCKED, NO_ANSWER, SPINS = -1, -2, -3


def final_answers(status, cycles, results=None) -> np.ndarray:
    """The final answers of the program's rows. ``results[k]`` (the
    program's full re-simulation of row k, or None) is read only where row
    k is not REUSED, so a block the solver reused whole pays nothing."""
    status = np.asarray(status)
    final = np.where(status == REUSED, np.asarray(cycles, np.int64),
                     NO_ANSWER)
    if results is not None:
        for k in np.flatnonzero(status != REUSED):
            r = results[k]
            if r is not None:
                final[k] = DEADLOCKED if r.deadlock else int(r.cycles)
    return final


def reference_answers(status, cycles) -> np.ndarray:
    """Final answers from the reference's ``(status, cycles)``: a livelock
    is an answer the program never gives."""
    status = np.asarray(status)
    return np.select([status == REUSED, status == DEADLOCK,
                      status == LIVELOCK],
                     [np.asarray(cycles, np.int64), DEADLOCKED, SPINS],
                     NO_ANSWER)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` row positions, drawn from the seed, in order."""
    if n <= k:
        return np.arange(n)
    return np.sort(rng_for(seed, "check").choice(n, size=k, replace=False))


def judge(run) -> Dict:
    D, status, _cycles, _violated, _at, final = run.record.answers()
    unanswered = int(np.count_nonzero(~np.isin(status, SOLVER_STATUSES)))
    unanswered += max(int(run.record.sent) - len(status), 0)
    pick = sample(len(status), int(run.mix["check_rows"]), run.seed)
    got = final[pick]
    if run.substitute is not None:
        # the control: the reference's own (status, cycles) in the
        # program's place
        got = reference_answers(*run.substitute(run, D[pick])[:2])
    want = reference_answers(*simulate_rows(run.design, D[pick]))
    numbers = {"unanswered": {"value": unanswered, "limit": 0},
               "mismatched": {"value": int(np.count_nonzero(got != want)),
                              "limit": 0}}
    return {"correct": bool(len(pick)) and all(
                v["value"] <= v["limit"] for v in numbers.values()),
            "checked": int(len(pick)), "numbers": numbers}
