"""Plain event-level simulation of a FIFO dataflow design.

The cost model is the OmniSim paper's, with registered FIFOs. Every module
starts with its clock at cycle 1 and yields ops in order:

* a blocking read, ``("r", f)``, of the r-th item of FIFO f commits at
  ``u = max(clock, time(r-th write) + 1)``: a value written in cycle t is
  readable from cycle t + 1 on, and a read retries until then;
* a blocking write, ``("w", f)`` or ``("w", f, value)``, the w-th of FIFO
  f of depth S, commits at ``u = clock`` if ``w <= S``, else at
  ``u = max(clock, time((w-S)-th read) + 1)``: the occupancy seen in cycle
  t counts only the commits of cycles before t;
* either way the module's clock moves to ``u + 1``;
* a non-blocking access or a probe samples once, in cycle ``t = clock``,
  against the commits of cycles before t, and moves the clock to t + 1:
  ``("rnb", f)`` succeeds, and commits its read at t, iff the r-th write
  committed before t; ``("wnb", f, value)`` succeeds, and commits its write
  at t, iff ``w <= S`` or the (w-S)-th read committed before t;
  ``("empty", f)`` is true iff a blocking read would not succeed in cycle
  t, ``("full", f)`` iff a blocking write would not;
* ``("d", n)`` moves the clock on by n cycles and is no event.

A design's cycle count is the largest final clock of its modules. A depth
row under which every module that has ops left waits on a blocking access
whose item never comes is a deadlock.

Two paths work these rules out:

* a copy whose modules yield only two-element blocking ops carries no data,
  so its op lists are fixed: they are expanded once (``Design.codes``) and
  run module by module, each until it blocks, round and round until all
  are done or none can move (a deadlock);
* every other copy runs event by event: each module's next op is taken in
  the order of its cycle (a heap), so a sample in cycle t sees every commit
  before t and none after; a module that blocks waits until the item it
  needs commits. The heap running empty while modules have ops left is the
  deadlock. A design that polls with non-blocking accesses can instead spin
  forever: the program under test gives no answer there either (its engine
  gives up after 50 000 000 steps, "possible livelock"), so a run that
  takes more than ``max_ops`` ops (by default the same number) is a
  livelock, an answer the program never gives. No cycle count is capped.

``dtype`` is the arithmetic of the commit times: exact Python integers by
default; ``"float16"`` rounds every commit time to the nearest
half-precision float, which is the control of the benchmark's comparison
(an answer that is close but not exact).
"""
from __future__ import annotations

import heapq
import importlib.util
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DESIGNS = Path(__file__).resolve().parent / "designs"
# status codes: the first two as the program under test numbers them; the
# program has no livelock verdict (it raises instead)
REUSED, DEADLOCK, LIVELOCK = 0, 1, -1
# the ops of the general path, and the number of graph events each makes
_ACCESSES = ("r", "w", "rnb", "wnb", "full", "empty")
MAX_OPS = 50_000_000


class Design:
    """A frozen design, ``<where>/<name>.py`` (by default
    ``simbench/reference/designs/``), at its parameters.

    ``codes[m]`` lists the reads and writes that module m commits, each
    ``2 * fifo + is_write``: for a copy of blocking ops alone, every op; for
    a copy that gives ``depths(**params)``, the commits of its run at those
    depths (the base that the program re-solves from), as far as it gets
    where it deadlocks there. ``n_nodes``, ``n_reads`` and ``n_writes``
    count the same run: every access, a start per module and an end per
    module that finishes; the reads and writes committed.
    """

    def __init__(self, name: str, params: Dict, where: Path = DESIGNS):
        spec = importlib.util.spec_from_file_location(
            f"simbench.reference.designs.{name}", Path(where) / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.name = name
        self.params = dict(params)
        self.fifos: Tuple[str, ...] = tuple(mod.fifos(**params))
        self.bodies = list(mod.modules(**params))
        index = {f: i for i, f in enumerate(self.fifos)}
        depths = getattr(mod, "depths", None)
        self.static = depths is None
        if self.static:
            self.codes: List[List[int]] = []
            for body in self.bodies:
                ops = []
                for op in body():
                    if len(op) != 2 or op[0] not in ("r", "w"):
                        raise ValueError(
                            f"{name}: op {op!r} needs the general path: "
                            f"give depths(**params) in the frozen copy")
                    ops.append(2 * index[op[1]] + (op[0] == "w"))
                self.codes.append(ops)
            self.default_depths = None
            self.n_events = sum(len(c) for c in self.codes)
            self.n_finished = len(self.codes)
        else:
            self.default_depths = tuple(int(d) for d in depths(**params))
            log = _run_events(self, self.default_depths, False, MAX_OPS)
            if log.status == LIVELOCK:
                raise ValueError(f"{name} spins at its default depths "
                                 f"{self.default_depths}")
            self.codes = log.codes
            self.n_events, self.n_finished = log.events, log.finished

    @property
    def n_nodes(self) -> int:
        return self.n_events + len(self.codes) + self.n_finished

    @property
    def n_reads(self) -> int:
        return sum(1 for c in self.codes for x in c if not x & 1)

    @property
    def n_writes(self) -> int:
        return sum(1 for c in self.codes for x in c if x & 1)


def simulate(design: Design, depths: Sequence[int], dtype: str = "int",
             max_ops: int = MAX_OPS) -> Tuple[int, int]:
    """``(status, cycles)`` of ``design`` under one depth row: REUSED and
    the cycle count, or DEADLOCK or LIVELOCK and -1."""
    nf = len(design.fifos)
    if len(depths) != nf:
        raise ValueError(f"{len(depths)} depths for {nf} FIFOs")
    if dtype not in ("int", "float16"):
        raise ValueError(f"unknown dtype {dtype!r}")
    S = [int(d) for d in depths]
    half = dtype == "float16"
    if design.static:
        return _run_static(design.codes, S, half)
    log = _run_events(design, S, half, max_ops)
    return log.status, log.cycles


def simulate_rows(design: Design, rows: np.ndarray,
                  dtype: str = "int") -> Tuple[np.ndarray, np.ndarray]:
    """``simulate`` over each row of a (K, F) depth matrix."""
    status = np.zeros(len(rows), np.int64)
    cycles = np.zeros(len(rows), np.int64)
    for k, row in enumerate(rows):
        status[k], cycles[k] = simulate(design, row, dtype)
    return status, cycles


def _round(u: int, half: bool) -> int:
    return int(np.float16(u)) if half else u


def _run_static(codes: List[List[int]], S: List[int],
                half: bool) -> Tuple[int, int]:
    """The fixed op lists of a blocking copy, module by module."""
    nf = len(S)
    wt: List[List[int]] = [[] for _ in range(nf)]
    rt: List[List[int]] = [[] for _ in range(nf)]
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


class _Spins(Exception):
    """A run that passed its op budget."""


class _Log(NamedTuple):
    """A run of the general path: its answer, each module's commits, the
    accesses that took place and the modules that finished."""
    status: int
    cycles: int
    codes: List[List[int]]
    events: int
    finished: int


def _run_events(design: Design, S: Sequence[int], half: bool,
                max_ops: int) -> _Log:
    """The general path: every module's generator, driven in cycle order."""
    index = {f: i for i, f in enumerate(design.fifos)}
    nf = len(S)
    wt: List[List[int]] = [[] for _ in range(nf)]      # write commit times
    vals: List[list] = [[] for _ in range(nf)]         # written values
    rt: List[List[int]] = [[] for _ in range(nf)]      # read commit times
    reader: List[Optional[int]] = [None] * nf          # blocked reader
    writer: List[Optional[int]] = [None] * nf          # blocked writer
    gens = [body() for body in design.bodies]
    M = len(gens)
    clock = [1] * M
    op: List[Optional[tuple]] = [None] * M
    codes: List[List[int]] = [[] for _ in range(M)]
    done = 0
    events = 0
    ops = 0
    heap: List[Tuple[int, int]] = []

    def advance(m: int, sent) -> None:
        """Send ``sent`` into module m, take its ops up to its next access
        and queue it at its clock; or close it."""
        nonlocal done, ops
        g = gens[m]
        while True:
            ops += 1
            if ops > max_ops:
                raise _Spins
            try:
                nxt = g.send(sent)
            except StopIteration:
                op[m] = None
                done += 1
                return
            sent = None
            if nxt[0] == "d":
                clock[m] += int(nxt[1])
                continue
            if nxt[0] not in _ACCESSES:
                raise ValueError(f"{design.name}: unknown op {nxt!r}")
            op[m] = nxt
            heapq.heappush(heap, (clock[m], m))
            return

    def commit_read(m: int, f: int, u: int):
        u = _round(u, half)
        r = len(rt[f])
        rt[f].append(u)
        codes[m].append(2 * f)
        w = writer[f]
        if w is not None:
            writer[f] = None
            heapq.heappush(heap, (max(clock[w], u + 1), w))
        return vals[f][r]

    def commit_write(m: int, f: int, u: int, value) -> None:
        u = _round(u, half)
        wt[f].append(u)
        vals[f].append(value)
        codes[m].append(2 * f + 1)
        r = reader[f]
        if r is not None:
            reader[f] = None
            heapq.heappush(heap, (max(clock[r], u + 1), r))

    def read_ready(f: int, t: int) -> bool:
        r = len(rt[f])
        return r < len(wt[f]) and wt[f][r] < t

    def write_ready(f: int, t: int) -> bool:
        tgt = len(wt[f]) - S[f]
        return tgt < 0 or (tgt < len(rt[f]) and rt[f][tgt] < t)

    def step(t: int, m: int) -> int:
        """Module m's access in cycle t: 1 where it takes place, 0 where it
        blocks."""
        kind = op[m][0]
        f = index[op[m][1]]
        if kind == "r":
            r = len(rt[f])
            if r >= len(wt[f]):
                reader[f] = m                  # waits for the r-th write
                return 0
            u = max(t, wt[f][r] + 1)
            got = commit_read(m, f, u)
        elif kind == "w":
            tgt = len(wt[f]) - S[f]
            if tgt < 0:
                u = t
            elif tgt < len(rt[f]):
                u = max(t, rt[f][tgt] + 1)
            else:
                writer[f] = m                  # waits for the tgt-th read
                return 0
            commit_write(m, f, u, op[m][2] if len(op[m]) > 2 else None)
            got = None
        elif kind == "rnb":
            u = t
            got = ((True, commit_read(m, f, t)) if read_ready(f, t)
                   else (False, None))
        elif kind == "wnb":
            u, got = t, write_ready(f, t)
            if got:
                commit_write(m, f, t, op[m][2])
        elif kind == "empty":
            u, got = t, not read_ready(f, t)
        else:                                  # "full"
            u, got = t, not write_ready(f, t)
        clock[m] = _round(u, half) + 1
        advance(m, got)
        return 1

    try:
        for m in range(M):
            advance(m, None)
        while heap:
            events += step(*heapq.heappop(heap))
    except _Spins:
        return _Log(LIVELOCK, -1, codes, events, done)
    if done < M:
        return _Log(DEADLOCK, -1, codes, events, done)
    return _Log(REUSED, max(clock), codes, events, done)
