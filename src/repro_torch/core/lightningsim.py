"""Decoupled two-phase baseline simulator (LightningSim/V2-style), and a
Vitis-C-sim emulation used to reproduce the paper's Table 3 comparison.

PyTorch-port copy of ``repro.core.lightningsim`` (host logic, numpy).

Phase 1 (untimed): modules execute *sequentially* in declaration order with
infinite FIFO depths, recording a trace (the paper's event lists).  This is
exactly the regime in which LightningSim is sound: Type A designs only.  A
non-blocking access, a status probe, or a read from an empty FIFO under
sequential execution means the design is Type B/C → ``UnsupportedDesignError``
(LightningSim "supports only a limited subset of HLS designs").

Phase 2 (timed): the trace is compiled into a simulation graph — sequential
edges with static-schedule gaps, read-after-write edges, and depth-dependent
write-after-read edges — and the cycle count is the longest path.  Phase 2
alone re-runs in microseconds for new FIFO depths (LightningSim's incremental
strength on Type A designs, Table 6 baseline).

``csim`` emulates what Vitis C simulation does to Type B/C designs (paper
Table 3, first column): sequential execution where ``write_nb`` always
succeeds, streams are infinitely deep, reads from empty streams warn and
return 0, and leftover data warns — i.e. functionally wrong results.
"""
from __future__ import annotations

import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .events import UnsupportedDesignError
from .graph import longest_path_numpy
from .program import (Delay, Emit, Empty, Full, Program, Read, ReadNB,
                      SimResult, Write, WriteNB)


@dataclass
class _TraceEvent:
    module: int
    kind: str          # "read" | "write"
    fifo: int
    seq: int           # 1-based per fifo per kind
    gap: int           # schedule cycles since previous event of this module


@dataclass
class Phase1Trace:
    events: List[_TraceEvent] = field(default_factory=list)
    end_gap: List[int] = field(default_factory=list)   # per module
    outputs: Dict[str, Any] = field(default_factory=dict)


class LightningSim:
    """Two-phase decoupled simulator. Type A designs only."""

    def __init__(self, program: Program):
        self.program = program
        self.trace: Optional[Phase1Trace] = None
        # phase-2 cache
        self._csr = None

    # ---------------------------------------------------------------- phase 1
    def phase1(self, max_ops: int = 10_000_000) -> Phase1Trace:
        trace = Phase1Trace()
        buffers: Dict[int, deque] = {f.fid: deque() for f in self.program.fifos}
        w_seq = {f.fid: 0 for f in self.program.fifos}
        r_seq = {f.fid: 0 for f in self.program.fifos}
        ops = 0
        for mod in self.program.modules:
            gen = mod.fn()
            clock_gap = 1          # schedule distance since previous event
            send = None
            started = False
            while True:
                ops += 1
                if ops > max_ops:
                    raise UnsupportedDesignError(
                        f"{self.program.name}: module '{mod.name}' does not "
                        f"terminate under sequential execution (Type B/C)")
                try:
                    op = next(gen) if not started else gen.send(send)
                    started = True
                    send = None
                except StopIteration:
                    break
                if isinstance(op, Emit):
                    trace.outputs[op.key] = op.value
                    continue
                if isinstance(op, Delay):
                    clock_gap += op.cycles
                    continue
                if isinstance(op, (ReadNB, WriteNB, Empty, Full)):
                    raise UnsupportedDesignError(
                        f"{self.program.name}: non-blocking access in module "
                        f"'{mod.name}' — Type B/C design, not supported by the "
                        f"decoupled two-phase simulator")
                if isinstance(op, Read):
                    fid = op.fifo.fid
                    if not buffers[fid]:
                        raise UnsupportedDesignError(
                            f"{self.program.name}: module '{mod.name}' reads "
                            f"from empty FIFO '{op.fifo.name}' under "
                            f"sequential execution — cyclic dependency "
                            f"(Type B/C), not supported")
                    send = buffers[fid].popleft()
                    r_seq[fid] += 1
                    trace.events.append(_TraceEvent(mod.mid, "read", fid,
                                                    r_seq[fid], clock_gap))
                    clock_gap = 1
                elif isinstance(op, Write):
                    fid = op.fifo.fid
                    buffers[fid].append(op.value)
                    w_seq[fid] += 1
                    trace.events.append(_TraceEvent(mod.mid, "write", fid,
                                                    w_seq[fid], clock_gap))
                    clock_gap = 1
                else:  # pragma: no cover
                    raise TypeError(f"unknown op {op!r}")
            trace.end_gap.append(clock_gap)
        self.trace = trace
        self._build_static_graph()
        return trace

    # ---------------------------------------------------------------- phase 2
    def _build_static_graph(self) -> None:
        """Compile the trace into CSR parts that do not depend on depths."""
        tr = self.trace
        n_mod = len(self.program.modules)
        n = len(tr.events) + 2 * n_mod   # + START/END per module
        start_idx = {m: len(tr.events) + 2 * m for m in range(n_mod)}
        end_idx = {m: len(tr.events) + 2 * m + 1 for m in range(n_mod)}
        edges: List[Tuple[int, int, int]] = []   # (dst, src, weight)
        last_of_mod = dict(start_idx)
        # per-fifo event node ids, in seq order
        self.fifo_writes: Dict[int, List[int]] = {f.fid: [] for f in self.program.fifos}
        self.fifo_reads: Dict[int, List[int]] = {f.fid: [] for f in self.program.fifos}
        for i, ev in enumerate(tr.events):
            edges.append((i, last_of_mod[ev.module], ev.gap))
            last_of_mod[ev.module] = i
            if ev.kind == "write":
                self.fifo_writes[ev.fifo].append(i)
            else:
                self.fifo_reads[ev.fifo].append(i)
        for m in range(n_mod):
            edges.append((end_idx[m], last_of_mod[m], tr.end_gap[m]))
        # RAW edges: write#k -> read#k, weight 1
        for fid in self.fifo_writes:
            for wn, rn in zip(self.fifo_writes[fid], self.fifo_reads[fid]):
                edges.append((rn, wn, 1))
        self._static = (n, edges, {m: start_idx[m] for m in range(n_mod)},
                        {m: end_idx[m] for m in range(n_mod)})

    def phase2(self, depths=None) -> Tuple[int, np.ndarray]:
        """Stall analysis with concrete FIFO depths → cycle count."""
        assert self.trace is not None, "run phase1 first"
        if depths is None:
            depths = self.program.depths()
        n, base_edges, start_idx, _ = self._static
        edges = list(base_edges)
        # WAR edges: read#(w-S) -> write#w, weight 1
        for f in self.program.fifos:
            S = depths[f.fid]
            writes = self.fifo_writes[f.fid]
            reads = self.fifo_reads[f.fid]
            for w0, wn in enumerate(writes):       # w0 is 0-based (w = w0+1)
                if w0 + 1 > S:
                    tgt = w0 + 1 - S - 1
                    if tgt >= len(reads):
                        raise UnsupportedDesignError(
                            f"write #{w0+1} on '{f.name}' can never commit "
                            f"with depth {S} (deadlock)")
                    edges.append((wn, reads[tgt], 1))
        indptr = np.zeros(n + 1, dtype=np.int64)
        for dst, _, _ in edges:
            indptr[dst + 1] += 1
        indptr = np.cumsum(indptr)
        src = np.zeros(len(edges), dtype=np.int64)
        wgt = np.zeros(len(edges), dtype=np.int64)
        fill = indptr[:-1].copy()
        for dst, s, w in edges:
            src[fill[dst]] = s
            wgt[fill[dst]] = w
            fill[dst] += 1
        base = np.zeros(n, dtype=np.int64)   # START nodes at 0; rest from edges
        times = longest_path_numpy(indptr, src, wgt, base)
        return int(times.max()), times

    # ------------------------------------------------------------------- API
    def run(self, depths=None) -> SimResult:
        t0 = _time.perf_counter()
        self.phase1()
        t1 = _time.perf_counter()
        cycles, _ = self.phase2(depths)
        t2 = _time.perf_counter()
        res = SimResult(program=self.program.name,
                        outputs=dict(self.trace.outputs), cycles=cycles,
                        engine="lightningsim", depths=self.program.depths())
        res.stats = {"phase1_s": t1 - t0, "phase2_s": t2 - t1}
        return res

    def resimulate(self, depths) -> SimResult:
        """Incremental: phase 2 only (the baseline's Table 6 capability)."""
        t0 = _time.perf_counter()
        cycles, _ = self.phase2(depths)
        dt = _time.perf_counter() - t0
        res = SimResult(program=self.program.name,
                        outputs=dict(self.trace.outputs), cycles=cycles,
                        engine="lightningsim-incr", depths=tuple(depths))
        res.stats = {"phase2_s": dt}
        return res


# ------------------------------------------------------------------------
# Vitis C-sim emulation (paper Table 3, "C-sim" column)
# ------------------------------------------------------------------------
class CSimCrash(RuntimeError):
    """Emulates '@E Simulation failed: SIGSEGV.'"""


def csim(program: Program, max_ops: int = 10_000_000) -> SimResult:
    """Sequential C-semantics run: what Vitis C simulation would print.

    Streams are infinitely deep; ``write_nb`` always succeeds; ``read_nb``
    and ``empty``/``full`` see the instantaneous software state; reads from
    empty streams warn and return 0.  Infinite producer loops guarded by a
    done-signal never see the signal and crash (array overrun → SIGSEGV),
    exactly the failure modes of Table 3.
    """
    buffers: Dict[int, deque] = {f.fid: deque() for f in program.fifos}
    outputs: Dict[str, Any] = {}
    warnings: List[str] = []
    ops = 0
    try:
        for mod in program.modules:
            gen = mod.fn()
            send = None
            started = False
            while True:
                ops += 1
                if ops > max_ops:
                    raise CSimCrash("SIGSEGV")   # runaway loop → crash
                try:
                    op = next(gen) if not started else gen.send(send)
                    started = True
                    send = None
                except StopIteration:
                    break
                if isinstance(op, Emit):
                    outputs[op.key] = op.value
                elif isinstance(op, Delay):
                    pass
                elif isinstance(op, Read):
                    buf = buffers[op.fifo.fid]
                    if buf:
                        send = buf.popleft()
                    else:
                        warnings.append(
                            f"WARNING: Hls::stream '{op.fifo.name}' is read "
                            f"while empty, returning zero")
                        send = 0
                elif isinstance(op, Write):
                    buffers[op.fifo.fid].append(op.value)
                elif isinstance(op, ReadNB):
                    buf = buffers[op.fifo.fid]
                    send = (True, buf.popleft()) if buf else (False, None)
                elif isinstance(op, WriteNB):
                    buffers[op.fifo.fid].append(op.value)  # always "succeeds"
                    send = True
                elif isinstance(op, Empty):
                    send = not buffers[op.fifo.fid]
                elif isinstance(op, Full):
                    send = False                           # infinite stream
                else:  # pragma: no cover
                    raise TypeError(f"unknown op {op!r}")
    except (CSimCrash, IndexError):   # array overrun in an unterminated loop
        res = SimResult(program=program.name,
                        outputs={"__crash__": "@E Simulation failed: SIGSEGV."},
                        cycles=-1, engine="csim", depths=program.depths())
        return res
    for f in program.fifos:
        if buffers[f.fid]:
            warnings.append(
                f"WARNING: Hls::stream '{f.name}' contains leftover data")
    if warnings:
        outputs["__warnings__"] = warnings
    return SimResult(program=program.name, outputs=outputs, cycles=-1,
                     engine="csim", depths=program.depths())
