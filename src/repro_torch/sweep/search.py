"""Search strategies: FIFO-area minimization over the sweep-service stream.

PyTorch-port copy of ``repro.sweep.search`` (host logic, unchanged).

The service answers "what does this depth vector cost?"; these strategies
decide *which* vectors to ask about.  All three consume the same streaming
API (``service.sweep`` / ``service.stream``) and produce a
:class:`SearchOutcome` whose centerpiece is the Pareto frontier of
``(total FIFO depth, latency cycles)`` — the HLS designer's actual
decision surface: every point on it is a cheapest design at its speed.

  * :func:`grid_search` — uniform-depth grid, per-FIFO axis sweeps, or a
    (capped) full cartesian product;
  * :func:`random_search` — seeded uniform sampling of the depth box;
  * :func:`successive_halving` — rounds of evaluate → keep the best
    ``1/eta`` (latency-lexicographic: fastest first, cheapest among ties)
    → respawn shrink-mutated children, so the population drifts toward
    the low-area end of the frontier; survivors carry their verdicts
    forward (a search-level memo), so only never-seen configs are
    submitted.

Deadlocked / cancelled configurations are infeasible and never enter the
frontier; every feasible cycle count is exact (service conformance).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.dse import (CANCELLED, DEADLOCK, FAULTED, REJECTED, TIMED_OUT,
                        BatchOutcome)
from ..core.program import Program
from .scheduler import BULK
from .service import SweepService

# Statuses that can never enter the frontier.  DEADLOCK is a solver
# verdict (the config genuinely stalls); the other four are the sweep
# service's terminal statuses — the row was never exactly solved,
# so whatever its ``cycles`` field carries must not be trusted.  The
# remaining fallback statuses (CYCLE / VIOLATED) are refined by an exact
# engine re-simulation, so their feasibility is decided by the refined
# result (``cycles >= 0`` and ``not res.deadlock``), not the raw verdict.
_INFEASIBLE_STATUSES = (DEADLOCK, CANCELLED, FAULTED, TIMED_OUT, REJECTED)


@dataclass
class SearchOutcome:
    """Everything a search evaluated, plus the decision surface."""

    depths: np.ndarray            # (N, F) every evaluated candidate
    cycles: np.ndarray            # (N,) exact latency; -1 = infeasible
    feasible: np.ndarray          # (N,) bool
    pareto: List[Tuple[Tuple[int, ...], int, int]]
    # ^ [(depth vector, total depth, cycles)] sorted by ascending area
    best: Optional[Tuple[Tuple[int, ...], int]]   # fastest (cheapest on tie)
    rounds: int = 1

    def summary(self) -> str:
        front = ", ".join(f"(area={a}, cyc={c})" for _d, a, c in self.pareto)
        return (f"{len(self.depths)} evaluated, "
                f"{int(self.feasible.sum())} feasible, "
                f"pareto: {front or 'empty'}")


def _feasible_mask(out: BatchOutcome) -> np.ndarray:
    feas = (np.asarray(out.cycles) >= 0)
    feas &= ~np.isin(np.asarray(out.status), _INFEASIBLE_STATUSES)
    for k, res in enumerate(out.results):
        if res is not None and res.deadlock:
            feas[k] = False
    return feas


def pareto_front(depths: np.ndarray, cycles: np.ndarray,
                 feasible: Optional[np.ndarray] = None
                 ) -> List[Tuple[Tuple[int, ...], int, int]]:
    """Non-dominated ``(depth vector, total depth, cycles)`` points,
    minimizing both coordinates, sorted by ascending total depth."""
    D = np.asarray(depths)
    C = np.asarray(cycles)
    if feasible is None:
        feasible = C >= 0
    idx = np.flatnonzero(np.asarray(feasible))
    if len(idx) == 0:
        return []
    area = D[idx].sum(axis=1)
    order = idx[np.lexsort((C[idx], area))]      # by area, then cycles
    front: List[Tuple[Tuple[int, ...], int, int]] = []
    best_c = None
    for k in order:
        a, c = int(D[k].sum()), int(C[k])
        if best_c is not None and c >= best_c:
            continue                              # dominated (or duplicate)
        front.append((tuple(int(x) for x in D[k]), a, c))
        best_c = c
    return front


def _outcome(service: SweepService, program: Program, D: np.ndarray,
             rounds: int = 1, **submit_kw) -> SearchOutcome:
    out = service.sweep(program, D, **submit_kw)
    feas = _feasible_mask(out)
    cycles = np.asarray(out.cycles)
    best = None
    if feas.any():
        f = np.flatnonzero(feas)
        k = f[np.lexsort((D[f].sum(axis=1), cycles[f]))[0]]
        best = (tuple(int(x) for x in D[k]), int(cycles[k]))
    return SearchOutcome(depths=D, cycles=cycles, feasible=feas,
                         pareto=pareto_front(D, cycles, feas), best=best,
                         rounds=rounds)


def grid_search(service: SweepService, program: Program,
                values: Sequence[int], mode: str = "uniform",
                base_depths: Optional[Sequence[int]] = None,
                limit: int = 4096, **submit_kw) -> SearchOutcome:
    """Grid sweep of the depth space.

    ``mode="uniform"``: every FIFO gets the same depth, one config per
    value.  ``mode="axes"``: vary one FIFO at a time around
    ``base_depths`` (defaults to the program's current depths) — the
    classic coordinate sweep, ``F * len(values)`` configs with heavy
    duplicate structure the scheduler dedups.  ``mode="product"``: the
    full cartesian product (guarded by ``limit``).
    """
    F = len(program.fifos)
    values = [int(v) for v in values]
    if mode == "uniform":
        D = np.asarray([[v] * F for v in values], dtype=np.int64)
    elif mode == "axes":
        base = np.asarray(base_depths if base_depths is not None
                          else program.depths(), dtype=np.int64)
        rows = [base.copy()]
        for f in range(F):
            for v in values:
                row = base.copy()
                row[f] = v
                rows.append(row)
        D = np.stack(rows)
    elif mode == "product":
        if len(values) ** F > limit:
            raise ValueError(
                f"product grid {len(values)}^{F} exceeds limit={limit}; "
                f"use mode='axes'/'uniform' or random_search")
        mesh = np.meshgrid(*([values] * F), indexing="ij")
        D = np.stack([m.reshape(-1) for m in mesh], axis=1).astype(np.int64)
    else:
        raise ValueError(f"unknown grid mode {mode!r}")
    return _outcome(service, program, D, **submit_kw)


def random_search(service: SweepService, program: Program, n: int,
                  lo: int = 1, hi: int = 16, seed: int = 0,
                  **submit_kw) -> SearchOutcome:
    """Seeded uniform sampling of ``[lo, hi]^F`` (``n`` configs)."""
    rng = np.random.default_rng(seed)
    D = rng.integers(lo, hi + 1, size=(n, len(program.fifos)),
                     dtype=np.int64)
    return _outcome(service, program, D, **submit_kw)


def successive_halving(service: SweepService, program: Program,
                       n0: int = 32, rounds: int = 3, eta: int = 2,
                       lo: int = 1, hi: int = 16, seed: int = 0,
                       **submit_kw) -> SearchOutcome:
    """Successive-halving FIFO-area minimization.

    Round 0 evaluates ``n0`` random configs; each later round keeps the
    best ``1/eta`` (fastest first, cheapest among equally fast) and
    refills the population with shrink-mutated children of the survivors
    (each child halves a random subset of its parent's depths, floored at
    ``lo``) — pushing along the frontier toward smaller FIFO area.
    Children that deadlock are simply infeasible and drop out at the next
    selection.  Survivors carry their known verdicts forward (a
    search-level memo), so each round only submits the configs it has
    never evaluated; all evaluations feed one final Pareto frontier.
    """
    submit_kw.setdefault("priority", BULK)
    rng = np.random.default_rng(seed)
    F = len(program.fifos)
    pop = rng.integers(lo, hi + 1, size=(n0, F), dtype=np.int64)
    memo: dict = {}                     # depth tuple -> (cycles, feasible)
    all_D: List[np.ndarray] = []
    all_C: List[np.ndarray] = []
    all_feas: List[np.ndarray] = []
    rounds_run = 0
    for _r in range(rounds):
        if not len(pop):
            break
        rounds_run += 1
        fresh = [row for row in pop if tuple(row) not in memo]
        if fresh:
            Df = np.stack(fresh)
            out = service.sweep(program, Df, **submit_kw)
            ofeas = _feasible_mask(out)
            for k, row in enumerate(Df):
                memo[tuple(row)] = (int(out.cycles[k]), bool(ofeas[k]))
            all_D.append(Df)
            all_C.append(np.asarray(out.cycles))
            all_feas.append(ofeas)
        cycles = np.asarray([memo[tuple(row)][0] for row in pop])
        feas = np.asarray([memo[tuple(row)][1] for row in pop])
        keep = max(1, len(pop) // eta)
        f = np.flatnonzero(feas)
        if len(f) == 0:
            break                       # all-infeasible: nothing to mutate
        order = f[np.lexsort((pop[f].sum(axis=1), cycles[f]))][:keep]
        survivors = pop[order]
        children = survivors.repeat(max(eta - 1, 1), axis=0)
        shrink = rng.random(children.shape) < 0.5
        children = np.where(shrink, np.maximum(children // 2, lo), children)
        pop = np.concatenate([survivors, children])
    if not all_D:
        # n0 == 0, or every round-0 row was already memoized by the caller:
        # a well-formed empty outcome, not an np.concatenate crash
        empty_D = np.zeros((0, F), dtype=np.int64)
        empty = np.zeros(0, dtype=np.int64)
        return SearchOutcome(depths=empty_D, cycles=empty,
                             feasible=np.zeros(0, dtype=bool), pareto=[],
                             best=None, rounds=rounds_run)
    D = np.concatenate(all_D)
    C = np.concatenate(all_C)
    feas = np.concatenate(all_feas)
    best = None
    if feas.any():
        f = np.flatnonzero(feas)
        k = f[np.lexsort((D[f].sum(axis=1), C[f]))[0]]
        best = (tuple(int(x) for x in D[k]), int(C[k]))
    return SearchOutcome(depths=D, cycles=C, feasible=feas,
                         pareto=pareto_front(D, C, feas), best=best,
                         rounds=rounds_run)
