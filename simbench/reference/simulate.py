"""Plain event-level simulation of a blocking-FIFO dataflow design.

The cost model is the OmniSim paper's for blocking accesses. Every module
starts with its clock at cycle 1. The r-th read of a FIFO commits at
``u = max(clock, time(r-th write) + 1)``; the w-th write of a FIFO of depth
S commits at ``u = clock`` if ``w <= S``, else at
``u = max(clock, time((w-S)-th read) + 1)``; either way the module's clock
moves to ``u + 1``. A design's cycle count is the largest final clock of its
modules. A depth row under which no module can move while some have ops
left is a deadlock.

The simulation runs each module until it blocks, then the next, round and
round until all are done. ``dtype`` is the arithmetic of the commit times:
exact Python integers by default; ``"float16"`` rounds every time to the
nearest half-precision float, which is the control of the benchmark's
comparison (an answer that is close but not exact).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

# status codes, as the program under test numbers them
REUSED, DEADLOCK = 0, 1


class Design:
    """A frozen design expanded into flat op codes, once per parameters.

    ``codes[m]`` lists module m's ops in order, each ``2 * fifo + is_write``.
    """

    def __init__(self, name: str, params: Dict):
        mod = importlib.import_module(f"simbench.reference.designs.{name}")
        self.name = name
        self.fifos: Tuple[str, ...] = tuple(mod.fifos(**params))
        index = {f: i for i, f in enumerate(self.fifos)}
        self.codes: List[List[int]] = []
        for body in mod.modules(**params):
            ops = []
            for kind, fifo in body():
                if kind not in ("r", "w"):
                    raise ValueError(f"unknown op {kind!r}")
                ops.append(2 * index[fifo] + (kind == "w"))
            self.codes.append(ops)

    @property
    def n_nodes(self) -> int:
        """Events of one run: every op, and a start and an end per module."""
        return sum(len(c) for c in self.codes) + 2 * len(self.codes)

    @property
    def n_reads(self) -> int:
        return sum(1 for c in self.codes for x in c if not x & 1)

    @property
    def n_writes(self) -> int:
        return sum(1 for c in self.codes for x in c if x & 1)


def simulate(design: Design, depths: Sequence[int],
             dtype: str = "int") -> Tuple[int, int]:
    """``(status, cycles)`` of ``design`` under one depth row.

    ``cycles`` is -1 for a deadlock.
    """
    nf = len(design.fifos)
    if len(depths) != nf:
        raise ValueError(f"{len(depths)} depths for {nf} FIFOs")
    S = [int(d) for d in depths]
    if dtype not in ("int", "float16"):
        raise ValueError(f"unknown dtype {dtype!r}")
    half = dtype == "float16"
    wt: List[List[int]] = [[] for _ in range(nf)]
    rt: List[List[int]] = [[] for _ in range(nf)]
    codes = design.codes
    M = len(codes)
    clock = [1] * M
    pc = [0] * M
    pending = [m for m in range(M) if codes[m]]
    while pending:
        moved = False
        still = []
        for m in pending:
            ops = codes[m]
            i, t, end = pc[m], clock[m], len(ops)
            while i < end:
                code = ops[i]
                f = code >> 1
                if code & 1:
                    w = wt[f]
                    tgt = len(w) - S[f]
                    if tgt >= 0:
                        r = rt[f]
                        if tgt >= len(r):
                            break
                        u = max(t, r[tgt] + 1)
                    else:
                        u = t
                    if half:
                        u = int(np.float16(u))
                    w.append(u)
                else:
                    r = rt[f]
                    k = len(r)
                    w = wt[f]
                    if k >= len(w):
                        break
                    u = max(t, w[k] + 1)
                    if half:
                        u = int(np.float16(u))
                    r.append(u)
                t = u + 1
                i += 1
            if i != pc[m]:
                moved = True
                pc[m], clock[m] = i, t
            if i < end:
                still.append(m)
        if not moved:
            return DEADLOCK, -1
        pending = still
    return REUSED, max(clock)


def simulate_rows(design: Design, rows: np.ndarray,
                  dtype: str = "int") -> Tuple[np.ndarray, np.ndarray]:
    """``simulate`` over each row of a (K, F) depth matrix."""
    status = np.zeros(len(rows), np.int64)
    cycles = np.zeros(len(rows), np.int64)
    for k, row in enumerate(rows):
        status[k], cycles[k] = simulate(design, row, dtype)
    return status, cycles
