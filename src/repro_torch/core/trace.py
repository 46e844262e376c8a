"""Trace compilation: replay the *initial* simulation at array speed
(PyTorch-port copy of ``repro.core.trace``: compiled replay and the hybrid
segmented replay).

The paper's Sec. 5.1 observation — once a design's FIFO-access trace is
known, simulation collapses from interpreting module bodies to replaying a
compiled trace — applied to the DSL engine.  This is host logic (plain
Python and numpy) and follows the reference line for line, so a trace
result equals the reference's field for field.

Pipeline (``simulate_traced``):

  1. **Record** (:func:`record_trace`): every module generator is entered
     exactly once and driven to completion under *untimed* Kahn-process-
     network semantics (unbounded FIFOs, block only on an empty read, round
     robin between modules).  Blocking dataflow designs are deterministic
     KPNs, so the recorded op stream, FIFO values and ``Emit`` outputs are
     identical to what the timed engine would produce — per module we keep
     flat op arrays (opcode, fifo id, inter-op gap in cycles).  A live
     non-blocking access or status probe makes control flow potentially
     cycle-dependent: recording aborts with :class:`TraceUnsupported` and
     the engine falls back to the hybrid segmented replay
     (:func:`simulate_hybrid`, below) or the generator path
     (``core/engine.py``).

  2. **Compile** (:func:`compile_trace`): the op arrays are turned into the
     simulation-graph skeleton *without running anything*: per-module chains
     (SEQ weights = 1 + accumulated ``Delay``), RAW edges (r-th read <- r-th
     write, weight 1) and, per depth vector, WAR edges (w-th write <-
     (w-S)-th read, weight 1).  After the run, steady-state loops are
     periodized — the trace *retained* on the engine is re-rolled to
     ``lead + body x reps`` (:meth:`ModuleTrace.periodize`).

  3. **Replay** (:func:`simulate_traced`): node commit times are the
     longest path over that graph, computed by a per-chain ``cummax``
     Gauss-Seidel fixpoint with dirty-chain tracking on the host.  The
     result is bit-identical to the generator engine (same cycles, outputs,
     FIFO tables and graph, in chain-major node order), plus a pre-built
     :class:`~repro_torch.core.incremental.CompiledGraph` so the first
     ``resimulate``/``resimulate_batch`` call — whose batched re-solve runs
     on the card — skips graph re-interpretation entirely.

Structural deadlocks (a blocking write whose target read never occurs, or
regenerated WAR edges forming a cycle) and untimed-KPN deadlocks (cyclic
blocking waits) raise :class:`TraceUnsupported`; the generator engine then
reproduces the paper-exact deadlock report (stall cycle, blocked modules).

Designs with live NB accesses / status probes take the hybrid segmented
replay (:class:`HybridSim`, :func:`simulate_hybrid`): blocking segments are
recorded and timed as flat arrays, and the generator protocol runs only at
the query points (see the section header further down).  It is host logic
too; its graphs feed the same device re-solves.

This file also holds the content-addressed design key that keys the sweep
service's warm cache (:func:`program_fingerprint`,
:func:`module_content_hash`).  Keys hash the port's own
:class:`~repro_torch.core.program.Fifo` and module bytecode, so they differ
from the reference's keys for the same design; nothing compares keys
across the two packages.

All times are hardware **cycles** (1-based commit cycles, START nodes at
cycle 0); all per-FIFO sequence numbers are 1-based **event** counts, as in
paper Table 2.
"""
from __future__ import annotations

import hashlib
import heapq
import types
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from itertools import repeat
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .events import Constraint, Node, NodeKind, RequestType, SimStats
from .program import (Delay, Emit, Empty, Fifo, Full, Program, Read, ReadNB,
                      SimResult, Write, WriteNB)

NEGI = np.int64(-(1 << 60))

# ---------------------------------------------------------------------------
# Flat op encoding (one row per recorded op).  OP_READ/OP_WRITE are the
# blocking accesses that survive into the straight-line compiled arrays —
# delays fold into the gap column, dead probes into a 1-cycle gap, Emits
# into the outputs dict.  The hybrid engine additionally records committed NB accesses (OP_READ_NB/OP_WRITE_NB),
# failed NB accesses (OP_NB_FAIL) and used status probes (OP_PROBE) as
# chain rows, so its segmented op streams share this encoding end to end.
# ---------------------------------------------------------------------------
OP_READ, OP_WRITE, OP_READ_NB, OP_WRITE_NB = 0, 1, 2, 3
OP_EMPTY, OP_FULL, OP_DELAY, OP_EMIT = 4, 5, 6, 7
OP_NB_FAIL, OP_PROBE, OP_PROBE_DEAD = 8, 9, 10

# node-kind codes of the compiled graph (map to events.NodeKind)
_NK_START, _NK_END, _NK_READ, _NK_WRITE = 0, 1, 2, 3
_NK_NB_FAIL, _NK_PROBE = 4, 5
_NK_TO_NODEKIND = {_NK_START: NodeKind.START, _NK_END: NodeKind.END,
                   _NK_READ: NodeKind.FIFO_READ, _NK_WRITE: NodeKind.FIFO_WRITE,
                   _NK_NB_FAIL: NodeKind.NB_FAIL, _NK_PROBE: NodeKind.PROBE}

# row opcode -> node-kind code (committed NB accesses become ordinary
# FIFO_READ/FIFO_WRITE nodes, exactly as in the generator engine)
_ROW_TO_NK = np.full(11, -1, dtype=np.int8)
_ROW_TO_NK[OP_READ] = _NK_READ
_ROW_TO_NK[OP_READ_NB] = _NK_READ
_ROW_TO_NK[OP_WRITE] = _NK_WRITE
_ROW_TO_NK[OP_WRITE_NB] = _NK_WRITE
_ROW_TO_NK[OP_NB_FAIL] = _NK_NB_FAIL
_ROW_TO_NK[OP_PROBE] = _NK_PROBE


class TraceUnsupported(Exception):
    """The design (or this run of it) cannot be trace-compiled.

    Raised on live non-blocking accesses / status probes (cycle-dependent
    control flow), untimed-KPN deadlock, SPSC violations, and depth-induced
    structural deadlocks or WAR cycles.  ``simulate(..., trace="auto")``
    catches it and falls back to the hybrid segmented replay
    (:func:`simulate_hybrid`) when ``dynamic`` is set — i.e. the only
    obstacle was cycle-dependent NB/probe control flow — and otherwise to
    the generator engine, which handles every design class (paper Fig. 3,
    Type A/B/C).
    """

    def __init__(self, msg: str, dynamic: bool = False):
        super().__init__(msg)
        self.dynamic = dynamic


# ---------------------------------------------------------------------------
# Recorded per-module op streams
# ---------------------------------------------------------------------------
@dataclass
class ModuleTrace:
    """One module's recorded op stream as flat arrays.

    ``kind[i]``/``fifo[i]`` identify the i-th FIFO access (OP_READ or
    OP_WRITE); ``gap[i]`` is the static-schedule distance in cycles from the
    previous access (1 + accumulated ``Delay``/dead-probe cycles — the SEQ
    edge weight of paper Sec. 7.3.1).  ``end_gap`` is the distance from the
    last access to the module END event.

    Periodized form (``reps > 1``): the stored arrays are the first ``lead``
    ops followed by one period of the steady-state loop body; the full
    stream is ``lead + body x reps`` (:meth:`expand`).
    """

    mid: int
    name: str
    kind: np.ndarray                # (L,) int8
    fifo: np.ndarray                # (L,) int64
    gap: np.ndarray                 # (L,) int64 — cycles
    end_gap: int
    lead: int = 0
    reps: int = 1
    # set by periodize() when the search found nothing, so re-periodizing
    # a trace (the reference's delta patch path periodizes spliced
    # recordings whose unchanged modules were already scanned) skips the
    # O(L^2) re-search
    no_period: bool = False

    @property
    def n_ops(self) -> int:
        """Number of FIFO accesses in the *expanded* stream (events)."""
        return self.lead + (len(self.kind) - self.lead) * self.reps

    @property
    def n_stored(self) -> int:
        """Number of op rows actually stored (lead + one body period)."""
        return len(self.kind)

    def expand(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the full (kind, fifo, gap) arrays via ``np.tile``."""
        if self.reps == 1:
            return self.kind, self.fifo, self.gap
        lead = self.lead
        return (
            np.concatenate([self.kind[:lead], np.tile(self.kind[lead:], self.reps)]),
            np.concatenate([self.fifo[:lead], np.tile(self.fifo[lead:], self.reps)]),
            np.concatenate([self.gap[:lead], np.tile(self.gap[lead:], self.reps)]),
        )

    def periodize(self, min_body: int = 4) -> "ModuleTrace":
        """Detect a steady-state loop and return the compressed trace.

        Finds the smallest period ``p`` (after a short lead of 0-2 warm-up
        ops) such that the remaining stream is an integer number of exact
        (kind, fifo, gap) repetitions, mirroring the paper's dynamic-stage
        unrolling of Sec. 5.1 in reverse: we *re-roll* the unrolled steady
        state.  Returns ``self`` unchanged when no period is found (and
        marks ``no_period`` so repeat calls are O(1)).
        """
        if self.no_period or self.reps != 1 or len(self.kind) < 2 * min_body:
            return self
        L = len(self.kind)
        key = self.fifo * 8 + self.kind          # one comparable op id
        for lead in range(0, min(3, L)):
            T = L - lead
            for p in range(1, T // 2 + 1):
                if T % p:
                    continue
                # cheap reject: first period vs second period
                if not np.array_equal(key[lead:lead + p],
                                      key[lead + p:lead + 2 * p]):
                    continue
                if not np.array_equal(self.gap[lead:lead + p],
                                      self.gap[lead + p:lead + 2 * p]):
                    continue
                # full verify: stream is periodic with period p after lead
                if (np.array_equal(key[lead:L - p], key[lead + p:])
                        and np.array_equal(self.gap[lead:L - p],
                                           self.gap[lead + p:])):
                    return ModuleTrace(
                        mid=self.mid, name=self.name,
                        kind=self.kind[:lead + p].copy(),
                        fifo=self.fifo[:lead + p].copy(),
                        gap=self.gap[:lead + p].copy(),
                        end_gap=self.end_gap, lead=lead, reps=T // p)
        self.no_period = True
        return self


@dataclass
class RecordedTrace:
    """A whole design's recorded op streams + functional results.

    ``outputs`` are the design's ``Emit`` records (complete — recording runs
    every module to termination); ``leftovers[fid]`` are payloads written
    but never consumed (they become the FIFO tables' end-of-run residue).
    ``steps`` counts per-op generator ``send`` calls; ``activations``
    counts module (re)activations by the recording scheduler — the
    analogue of the generator engine's task-resume counter.
    """

    program: str
    modules: List[ModuleTrace]
    outputs: Dict[str, Any]
    leftovers: List[list]
    skipped_probes: int = 0
    steps: int = 0
    activations: int = 0
    # --- optional functional capture (record_trace(keep_values=True)) ---
    # the delta layer (not ported yet) needs the *values* that flowed, not
    # just the op skeleton: per-FIFO written-value streams (complete, in
    # write order — SPSC means one writer per FIFO so this is also that
    # writer's per-FIFO write stream), per-module Emit records in emit
    # order, and per-module dead-probe counts.  None unless captured.
    values: Optional[List[list]] = None          # [fid] -> written values
    module_emits: Optional[List[list]] = None    # [mid] -> [(key, value)]
    module_skips: Optional[List[int]] = None     # [mid] -> dead probes

    @property
    def n_ops(self) -> int:
        return sum(m.n_ops for m in self.modules)

    @property
    def n_stored(self) -> int:
        return sum(m.n_stored for m in self.modules)

    def periodize(self) -> "RecordedTrace":
        """Compress every module stream in place; returns self."""
        self.modules = [m.periodize() for m in self.modules]
        return self


# ---------------------------------------------------------------------------
# Pass 1: record — generators entered at most once per module
# ---------------------------------------------------------------------------
_REC_QUANTUM = 256     # ops per activation before the recorder rotates


def record_trace(program: Program, max_steps: int = 50_000_000,
                 keep_values: bool = False) -> RecordedTrace:
    """Run every module generator once, untimed, and record its op stream.

    Untimed KPN semantics: FIFOs are unbounded, a ``Read`` from an empty
    FIFO parks the module until its (single) writer produces, modules are
    scheduled round-robin.  For blocking-only designs this yields exactly
    the functional behavior of the timed engine (KPN determinism); any live
    NB access/probe, a parked module that never wakes (cyclic blocking
    wait — a true design deadlock), or a second reader racing a parked one
    raises :class:`TraceUnsupported`.

    Each activation is bounded to ``_REC_QUANTUM`` ops before the scheduler
    rotates (legal under KPN determinism — any schedule records the same
    streams), so probing a *dynamic* design under ``trace="auto"`` aborts
    to the fallback after O(modules x quantum) ops instead of first
    recording some module's entire multi-thousand-op stream.

    Raises ``RuntimeError`` when ``max_steps`` generator resumptions are
    exceeded (possible livelock), matching the generator engine's budget.

    ``keep_values=True`` additionally captures the functional side of the
    run — per-FIFO written-value streams, per-module Emit lists and
    per-module dead-probe counts — which is what the delta layer needs to
    re-record a single edited module in isolation and verify its writes
    against the original streams.
    """
    modules = program.modules
    n_mod = len(modules)
    buffers: List[deque] = [deque() for _ in program.fifos]
    wvals: Optional[List[list]] = (
        [[] for _ in program.fifos] if keep_values else None)
    memits: Optional[List[list]] = (
        [[] for _ in range(n_mod)] if keep_values else None)
    mskips: Optional[List[int]] = [0] * n_mod if keep_values else None
    kinds: List[list] = [[] for _ in range(n_mod)]
    fids: List[list] = [[] for _ in range(n_mod)]
    gaps: List[list] = [[] for _ in range(n_mod)]
    end_gap = [1] * n_mod
    outputs: Dict[str, Any] = {}
    gens = [m.fn() for m in modules]
    done = [False] * n_mod
    parked: List[Optional[Read]] = [None] * n_mod
    gap_acc = [1] * n_mod
    waiting_reader: Dict[int, int] = {}
    skipped_probes = 0
    steps = 0
    activations = 0
    runq: deque = deque(range(n_mod))
    while runq:
        mid = runq.popleft()
        activations += 1
        gen_send = gens[mid].send
        kapp, fapp, gapp = kinds[mid].append, fids[mid].append, gaps[mid].append
        gap = gap_acc[mid]
        op = parked[mid]
        if op is not None:                 # woken: re-execute the parked Read
            parked[mid] = None
            fid = op.fifo.fid
            buf = buffers[fid]
            if not buf:                    # a second reader drained the FIFO
                raise TraceUnsupported(
                    f"{program.name}: FIFO '{op.fifo.name}' drained by "
                    f"another reader while '{modules[mid].name}' was parked "
                    f"— SPSC violation; deferring to the generator engine's "
                    f"endpoint check")
            send = buf.popleft()
            kapp(OP_READ)
            fapp(fid)
            gapp(gap)
            gap = 1
        else:
            send = None
        quantum = steps + _REC_QUANTUM
        while True:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"step budget exceeded ({max_steps}); possible livelock "
                    f"— neither OmniSim nor co-sim detects livelock")
            if steps > quantum and send is None and runq:
                runq.append(mid)        # rotate: bounded activation quantum
                break
            try:
                op = gen_send(send)
            except StopIteration:
                done[mid] = True
                end_gap[mid] = gap
                break
            send = None
            cls = op.__class__
            if cls is Read:
                fid = op.fifo.fid
                buf = buffers[fid]
                if buf:
                    send = buf.popleft()
                    kapp(OP_READ)
                    fapp(fid)
                    gapp(gap)
                    gap = 1
                else:
                    prev = waiting_reader.get(fid)
                    if prev is not None and prev != mid:
                        raise TraceUnsupported(
                            f"{program.name}: two modules read FIFO "
                            f"'{op.fifo.name}' — SPSC violation; deferring "
                            f"to the generator engine's endpoint check")
                    waiting_reader[fid] = mid
                    parked[mid] = op
                    break
            elif cls is Write:
                fid = op.fifo.fid
                buffers[fid].append(op.value)
                if wvals is not None:
                    wvals[fid].append(op.value)
                kapp(OP_WRITE)
                fapp(fid)
                gapp(gap)
                gap = 1
                if waiting_reader:
                    w = waiting_reader.pop(fid, None)
                    if w is not None:
                        runq.append(w)
            elif cls is Delay:
                gap += op.cycles
            elif cls is Emit:
                outputs[op.key] = op.value
                if memits is not None:
                    memits[mid].append((op.key, op.value))
            elif (cls is Empty or cls is Full) and not op.used:
                # dead probe (paper Sec. 7.3.2): costs 1 cycle, no query
                skipped_probes += 1
                if mskips is not None:
                    mskips[mid] += 1
                gap += 1
            elif cls in (ReadNB, WriteNB, Empty, Full):
                raise TraceUnsupported(
                    f"{program.name}: module '{modules[mid].name}' issues "
                    f"{cls.__name__} — outcome is cycle-dependent, control "
                    f"flow may diverge; using the hybrid segmented replay",
                    dynamic=True)
            else:
                raise TypeError(f"unknown op {op!r}")
        gap_acc[mid] = gap
    if not all(done):
        blocked = [modules[m].name for m in range(n_mod) if not done[m]]
        raise TraceUnsupported(
            f"{program.name}: cyclic blocking wait (untimed KPN deadlock) — "
            f"modules {blocked} never terminate; the generator engine will "
            f"report the exact stall cycle")
    mtraces = [
        ModuleTrace(mid=m, name=modules[m].name,
                    kind=np.asarray(kinds[m], dtype=np.int8),
                    fifo=np.asarray(fids[m], dtype=np.int64),
                    gap=np.asarray(gaps[m], dtype=np.int64),
                    end_gap=end_gap[m])
        for m in range(n_mod)
    ]
    return RecordedTrace(program=program.name, modules=mtraces,
                         outputs=outputs,
                         leftovers=[list(b) for b in buffers],
                         skipped_probes=skipped_probes, steps=steps,
                         activations=activations,
                         values=wvals, module_emits=memits,
                         module_skips=mskips)


# ---------------------------------------------------------------------------
# Pass 2: compile — op arrays -> simulation-graph skeleton
# ---------------------------------------------------------------------------
@dataclass
class CompiledTrace:
    """Depth-independent graph skeleton compiled from a RecordedTrace.

    Node ids are chain-major: module ``m`` owns the contiguous id range
    ``slices[m]`` as ``[START, op_0 .. op_{k-1}, END]``.  ``seq_w[i]`` is
    the SEQ-edge weight into node ``i`` (0 at chain heads); RAW edges are
    depth-independent; WAR edges are generated per depth vector by
    :meth:`war_edges`.  Everything is in cycles / 1-based event counts.
    """

    n: int
    n_modules: int
    slices: List[Tuple[int, int]]       # per-module (lo, hi) node id range
    seq_w: np.ndarray                   # (n,) int64 — SEQ weight into node
    base: np.ndarray                    # (n,) int64 — START time 0, else NEGI
    node_kind: np.ndarray               # (n,) int8 — _NK_* codes
    node_fifo: np.ndarray               # (n,) int64 — FIFO id or -1
    node_seq: np.ndarray                # (n,) int64 — 1-based fifo seq or -1
    fifo_w_nodes: List[np.ndarray]      # per FIFO: write node ids, seq order
    fifo_r_nodes: List[np.ndarray]      # per FIFO: read node ids, seq order
    fifo_wmod: np.ndarray               # per FIFO: writer module (-1 = none)
    fifo_rmod: np.ndarray               # per FIFO: reader module (-1 = none)
    raw_dst: np.ndarray                 # RAW edges (read <- write, w=1)
    raw_src: np.ndarray
    trace: RecordedTrace = field(repr=False, default=None)

    def war_edges(self, depths) -> Tuple[np.ndarray, np.ndarray]:
        """Regenerate the depth-dependent WAR edges for ``depths``.

        The w-th write of a FIFO with depth S waits on the (w-S)-th read
        (paper Table 2).  A write whose target read never occurs can never
        commit — a structural deadlock under these depths — which raises
        :class:`TraceUnsupported` so the generator engine can produce the
        paper-exact deadlock report.
        """
        dst_parts, src_parts = [], []
        for fid, w_nodes in enumerate(self.fifo_w_nodes):
            S = int(depths[fid])
            nw = len(w_nodes)
            if nw <= S:
                continue
            r_nodes = self.fifo_r_nodes[fid]
            if nw - len(r_nodes) > S:
                raise TraceUnsupported(
                    f"write #{len(r_nodes) + S + 1} on fifo {fid} can never "
                    f"commit with depth {S} (structural deadlock)")
            dst_parts.append(w_nodes[S:])
            src_parts.append(r_nodes[:nw - S])
        if not dst_parts:
            z = np.zeros(0, np.int64)
            return z, z
        return np.concatenate(dst_parts), np.concatenate(src_parts)


def compile_trace(rec: RecordedTrace, n_fifos: int) -> CompiledTrace:
    """Lower a RecordedTrace into the chain/edge arrays of CompiledTrace.

    Purely array work — no generator is resumed.  Enforces the engine's
    SPSC endpoint rule (one writer module and one reader module per FIFO)
    on the recorded streams; violations raise :class:`TraceUnsupported` so
    the generator engine surfaces its own AssertionError.
    """
    n_mod = len(rec.modules)
    expanded = [m.expand() for m in rec.modules]
    counts = [len(k) for (k, _, _) in expanded]
    n = sum(counts) + 2 * n_mod
    seq_w = np.zeros(n, dtype=np.int64)
    node_kind = np.empty(n, dtype=np.int8)
    node_fifo = np.full(n, -1, dtype=np.int64)
    node_seq = np.full(n, -1, dtype=np.int64)
    base = np.full(n, NEGI, dtype=np.int64)
    slices: List[Tuple[int, int]] = []
    all_fifo, all_kind, all_node, all_mod = [], [], [], []
    off = 0
    for m, (k, f, g) in enumerate(expanded):
        L = counts[m]
        hi = off + L + 2
        slices.append((off, hi))
        node_kind[off] = _NK_START
        base[off] = 0                       # START commits at cycle 0
        node_kind[off + 1:hi - 1] = np.where(k == OP_WRITE, _NK_WRITE, _NK_READ)
        node_kind[hi - 1] = _NK_END
        node_fifo[off + 1:hi - 1] = f
        seq_w[off + 1:hi - 1] = g
        seq_w[hi - 1] = rec.modules[m].end_gap
        all_fifo.append(f)
        all_kind.append(k)
        all_node.append(np.arange(off + 1, hi - 1, dtype=np.int64))
        all_mod.append(np.full(L, m, dtype=np.int64))
        off = hi
    fifo_all = (np.concatenate(all_fifo) if all_fifo
                else np.zeros(0, np.int64))
    kind_all = (np.concatenate(all_kind).astype(np.int64) if all_kind
                else np.zeros(0, np.int64))
    node_all = (np.concatenate(all_node) if all_node
                else np.zeros(0, np.int64))
    mod_all = (np.concatenate(all_mod) if all_mod
               else np.zeros(0, np.int64))
    # group events by (fifo, kind); stable sort keeps each side's per-module
    # issue order, which IS commit/seq order because FIFOs are SPSC
    order = np.lexsort((kind_all, fifo_all))
    f_s, k_s, n_s, m_s = (fifo_all[order], kind_all[order], node_all[order],
                          mod_all[order])
    fifo_w_nodes: List[np.ndarray] = []
    fifo_r_nodes: List[np.ndarray] = []
    fifo_wmod = np.full(n_fifos, -1, dtype=np.int64)
    fifo_rmod = np.full(n_fifos, -1, dtype=np.int64)
    raw_dst_parts, raw_src_parts = [], []
    for fid in range(n_fifos):
        lo = int(np.searchsorted(f_s, fid, side="left"))
        hi = int(np.searchsorted(f_s, fid, side="right"))
        mid_split = lo + int(np.searchsorted(k_s[lo:hi], OP_WRITE))
        r_nodes = n_s[lo:mid_split]
        w_nodes = n_s[mid_split:hi]
        for side_nodes, side_mods, table in (
                (r_nodes, m_s[lo:mid_split], fifo_rmod),
                (w_nodes, m_s[mid_split:hi], fifo_wmod)):
            if len(side_nodes):
                mods = np.unique(side_mods)
                if len(mods) > 1:
                    raise TraceUnsupported(
                        f"fifo {fid} has {len(mods)} endpoint modules on one "
                        f"side — SPSC violation; deferring to the generator "
                        f"engine's endpoint check")
                table[fid] = int(mods[0])
        fifo_w_nodes.append(np.ascontiguousarray(w_nodes))
        fifo_r_nodes.append(np.ascontiguousarray(r_nodes))
        node_seq[w_nodes] = np.arange(1, len(w_nodes) + 1)
        node_seq[r_nodes] = np.arange(1, len(r_nodes) + 1)
        nr = len(r_nodes)
        if nr:                              # r-th read <- r-th write, w=1
            raw_dst_parts.append(r_nodes)
            raw_src_parts.append(w_nodes[:nr])
    raw_dst = (np.concatenate(raw_dst_parts) if raw_dst_parts
               else np.zeros(0, np.int64))
    raw_src = (np.concatenate(raw_src_parts) if raw_src_parts
               else np.zeros(0, np.int64))
    return CompiledTrace(n=n, n_modules=n_mod, slices=slices, seq_w=seq_w,
                         base=base, node_kind=node_kind, node_fifo=node_fifo,
                         node_seq=node_seq, fifo_w_nodes=fifo_w_nodes,
                         fifo_r_nodes=fifo_r_nodes, fifo_wmod=fifo_wmod,
                         fifo_rmod=fifo_rmod, raw_dst=raw_dst,
                         raw_src=raw_src, trace=rec)


# ---------------------------------------------------------------------------
# Pass 3: replay — Gauss-Seidel chain fixpoint (array-level dispatch)
# ---------------------------------------------------------------------------
def _cross_buckets(ct: CompiledTrace, war_dst: np.ndarray,
                   war_src: np.ndarray, starts: np.ndarray) -> Dict:
    """Bucket cross edges by source chain (RAW: writer -> reader module;
    WAR: reader -> writer module) — no sort needed, FIFO sides are SPSC.

    Pure function of the trace skeleton + WAR edge set, so a caller may
    cache the result and reuse it whenever the skeleton and depth vector
    are unchanged (the reference's delta patch path does).
    """
    out_buckets: Dict[int, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
    for dst, src in ((ct.raw_dst, ct.raw_src), (war_dst, war_src)):
        if not len(dst):
            continue
        # split by fifo-contiguous runs: each concatenated part came from
        # one fifo, i.e. one (src chain, dst chain) pair
        sch = np.searchsorted(starts, src, "right") - 1
        dch = np.searchsorted(starts, dst, "right") - 1
        cut = np.flatnonzero(np.diff(sch) | np.diff(dch))
        bounds = np.concatenate([[0], cut + 1, [len(dst)]])
        run_sc, run_dc = sch[bounds[:-1]], dch[bounds[:-1]]
        for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            out_buckets.setdefault(int(run_sc[i]), []).append(
                (int(run_dc[i]), src[a:b], dst[a:b]))
    return out_buckets


def _solve_times(ct: CompiledTrace, war_dst: np.ndarray,
                 war_src: np.ndarray,
                 warm: Optional[Tuple[np.ndarray, List[int]]] = None,
                 buckets: Optional[Dict] = None,
                 ) -> Tuple[np.ndarray, int]:
    """Longest-path node times over SEQ chains + RAW/WAR cross edges.

    Within a chain, ``t = cw + cummax(c - cw)`` (cw = cumulative SEQ
    weight) resolves all sequential propagation in one vectorized pass;
    cross edges are bucketed by (source module, destination module) — one
    bucket per FIFO side, since FIFOs are SPSC — and swept Gauss-Seidel in
    module order with dirty-chain tracking, so each sweep only recomputes
    chains some cross edge actually moved.  Converges in O(module-graph
    hops), not O(events).  A WAR cycle makes times grow past the acyclic
    bound: raises :class:`TraceUnsupported` (the timed engine would
    deadlock; the generator path reports it exactly).

    ``warm = (old_times, dirty_chains)`` seeds the fixpoint from a prior
    solution of the *same* graph with only ``dirty_chains`` marked dirty —
    the edit-and-resimulate fast path of the delta layer.  Sound when
    every weight change is an increase (the old solution is then a lower
    bound of the new least fixpoint, and ascending Gauss-Seidel converges
    to the least fixpoint from any lower bound); if weights *decreased*,
    the result can land above the true fixpoint, so warm callers MUST
    check the result (``verify_times``) and re-solve cold on mismatch.

    ``buckets`` optionally supplies a prebuilt :func:`_cross_buckets`
    table (it must match ``ct`` + the WAR edge *content* exactly — the
    patch path reuses the snapshot's table when skeleton and depths are
    unchanged).

    Returns ``(times, sweeps)`` — times in cycles.
    """
    n = ct.n
    n_ch = ct.n_modules
    cw = np.concatenate([np.cumsum(ct.seq_w[lo:hi]) for (lo, hi) in ct.slices]) \
        if n else np.zeros(0, np.int64)
    c = ct.base.copy()
    t = np.full(n, NEGI, dtype=np.int64)
    starts = np.asarray([lo for (lo, _) in ct.slices] or [0], np.int64)
    out_buckets = buckets if buckets is not None \
        else _cross_buckets(ct, war_dst, war_src, starts)

    bound = int(ct.seq_w.sum() + len(ct.raw_dst) + len(war_dst) + 1)
    if warm is not None:
        old_t, dirty_chains = warm
        t = old_t.astype(np.int64, copy=True)
        # re-derive cross contributions from the old solution (one
        # vectorized pass), then only the edited chains start dirty
        for dst, src in ((ct.raw_dst, ct.raw_src), (war_dst, war_src)):
            if len(dst):
                np.maximum.at(c, dst, t[src] + 1)
        dirty = np.zeros(n_ch, dtype=bool)
        dirty[list(dirty_chains)] = True
    else:
        dirty = np.ones(n_ch, dtype=bool)
    sweeps = 0
    max_sweeps = n + 2
    while dirty.any():
        sweeps += 1
        if sweeps > max_sweeps or (sweeps > n_ch + 4 and t.max() > bound):
            raise TraceUnsupported(
                "WAR edges form a cycle — the recorded event order is "
                "invalid under these depths (the design deadlocks)")
        for ci in range(n_ch):
            if not dirty[ci]:
                continue
            dirty[ci] = False
            lo, hi = ct.slices[ci]
            seg = c[lo:hi] - cw[lo:hi]
            np.maximum.accumulate(seg, out=seg)
            seg += cw[lo:hi]
            if np.array_equal(seg, t[lo:hi]):
                continue
            t[lo:hi] = seg
            for (dc, s_ids, d_ids) in out_buckets.get(ci, ()):
                cand = t[s_ids] + 1
                old = c[d_ids]
                moved = cand > old
                if moved.any():
                    c[d_ids] = np.maximum(old, cand)
                    dirty[dc] = True
    return t, sweeps


# ---------------------------------------------------------------------------
# Array-backed simulation graph (API-compatible with graph.SimGraph reads)
# ---------------------------------------------------------------------------
class TraceSimGraph:
    """The replayed simulation graph, stored as numpy arrays.

    Drop-in for :class:`~repro_torch.core.graph.SimGraph` consumers that *read*
    a finished graph — ``nodes`` (materialized lazily as
    :class:`~repro_torch.core.events.Node` objects for e.g. the taxonomy
    classifier), ``times()``, ``to_csr()``, ``n_nodes``/``n_edges`` — while
    the hot path never touches per-node Python objects.  Node times are in
    cycles; node ids are chain-major (see :class:`CompiledTrace`), which is
    *not* a topological order — use level-scheduled or fixpoint longest-path
    backends, not ``longest_path_python``.
    """

    def __init__(self, ct: CompiledTrace, times: np.ndarray,
                 war_dst: np.ndarray, war_src: np.ndarray,
                 module_arr: np.ndarray):
        self._ct = ct
        self._times = times
        self._module = module_arr
        self._cross_dst = (np.concatenate([ct.raw_dst, war_dst])
                           if len(ct.raw_dst) or len(war_dst)
                           else np.zeros(0, np.int64))
        self._cross_src = (np.concatenate([ct.raw_src, war_src])
                           if len(ct.raw_src) or len(war_src)
                           else np.zeros(0, np.int64))
        self._nodes: Optional[List[Node]] = None

    # -- SimGraph read API ---------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self._ct.n

    @property
    def n_edges(self) -> int:
        # SEQ edges into every non-head node + RAW/WAR cross edges
        return (self._ct.n - self._ct.n_modules) + len(self._cross_dst)

    def times(self) -> np.ndarray:
        """Commit cycle of every node (same as SimGraph.times())."""
        return self._times.copy()

    @property
    def nodes(self) -> List[Node]:
        """Materialize Node objects (lazily, once) for object-level readers."""
        if self._nodes is None:
            ct = self._ct
            nodes = []
            heads = {lo for (lo, _) in ct.slices}
            for i in range(ct.n):
                node = Node(idx=i, module=int(self._module[i]),
                            kind=_NK_TO_NODEKIND[int(ct.node_kind[i])],
                            time=int(self._times[i]),
                            fifo=int(ct.node_fifo[i]),
                            seq=int(ct.node_seq[i]))
                if i not in heads:
                    node.preds.append((i - 1, int(ct.seq_w[i])))
                nodes.append(node)
            for dst, src in zip(self._cross_dst, self._cross_src):
                nodes[int(dst)].preds.append((int(src), 1))
            self._nodes = nodes
        return self._nodes

    def to_csr(self):
        """CSR by destination — same convention as SimGraph.to_csr()."""
        ct = self._ct
        n = ct.n
        head_mask = np.zeros(n, dtype=bool)
        for (lo, _) in ct.slices:
            head_mask[lo] = True
        seq_dst = np.flatnonzero(~head_mask)
        dsts = np.concatenate([seq_dst, self._cross_dst])
        srcs = np.concatenate([seq_dst - 1, self._cross_src])
        wgts = np.concatenate([ct.seq_w[seq_dst],
                               np.ones(len(self._cross_dst), np.int64)])
        order = np.argsort(dsts, kind="stable")
        counts = np.bincount(dsts, minlength=n)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        base = np.where(indptr[1:] == indptr[:-1], self._times, 0)
        return indptr, srcs[order], wgts[order], base.astype(np.int64)
class _LazyConstraints(list):
    """Constraint records materialized on first access.

    The same trick as :attr:`TraceSimGraph.nodes`: query-dominated runs
    carry one :class:`~repro_torch.core.events.Constraint` per query, but the
    incremental/DSE consumers read the *compiled* constraint arrays of the
    pre-built CompiledGraph — the object records exist for object-level
    readers (tests, reporting) and are built on the first access.  Every
    reader *and* mutator of the list API forces materialization first (see
    the wrapper loop below), so a partially-initialized view can never
    leak; being a list subclass, reflected comparisons against plain lists
    dispatch here first, so those force too.
    """

    __slots__ = ("_thunk",)

    def __init__(self, thunk):
        super().__init__()
        self._thunk = thunk

    def _force(self) -> None:
        thunk, self._thunk = self._thunk, None
        if thunk is not None:
            list.extend(self, thunk())

    __hash__ = None


def _lazy_forcing(name):
    base = getattr(list, name)

    def method(self, *args, **kwargs):
        self._force()
        for a in args:
            if type(a) is _LazyConstraints:
                a._force()
        return base(self, *args, **kwargs)

    method.__name__ = name
    return method


for _name in ("__len__", "__iter__", "__getitem__", "__eq__", "__ne__",
              "__lt__", "__le__", "__gt__", "__ge__", "__contains__",
              "__repr__", "__reversed__", "__add__", "__mul__", "__rmul__",
              "__iadd__", "__imul__", "__setitem__", "__delitem__",
              "count", "index", "copy", "append", "extend", "insert",
              "remove", "pop", "sort", "reverse", "clear"):
    setattr(_LazyConstraints, _name, _lazy_forcing(_name))
del _name


# ---------------------------------------------------------------------------
# Content-addressed design keys: warm-cache reuse of the pre-built graph
# ---------------------------------------------------------------------------
_FP_PRIM = (str, int, float, bool, bytes, complex, type(None))






# ---------------------------------------------------------------------------
# Content-addressed design keys: warm-cache reuse of the pre-built graph
# ---------------------------------------------------------------------------
_FP_PRIM = (str, int, float, bool, bytes, complex, type(None))


def _fp_plain(obj, depth: int = 0) -> bool:
    """True when ``obj`` is pure primitive data (possibly nested in plain
    lists/tuples): its ``repr`` is then deterministic content, so the
    fingerprint walk can hash it in one C-level call instead of recursing
    per element.  Exact-type checks keep subclasses (enums, numpy scalars,
    repr-overriding wrappers) on the structural path.
    """
    t = type(obj)
    if t in _FP_PRIM:
        return True
    if (t is tuple or t is list) and depth <= 8:
        for x in obj:                    # plain loop: no genexpr frames —
            if not _fp_plain(x, depth + 1):   # this predicate runs per
                return False             # element of every macro script
        return True
    return False


def _fp_update(h, obj, depth: int = 0, fifo_depth: bool = True,
               memo: Optional[dict] = None) -> None:
    """Feed ``obj`` into hash ``h`` by *content*, not identity.

    Function objects are fingerprinted by bytecode + consts + defaults +
    closure contents (recursively), FIFOs by name/depth, arrays by bytes —
    so two Programs built by the same design function with the same
    arguments hash equal even though every call allocates fresh
    function/Fifo objects, while changing any captured argument
    (``items=512`` vs ``1024``) changes the key.  ``fifo_depth=False``
    hashes captured FIFOs by name only (the depth vector enters
    :func:`program_fingerprint` once, through its FIFO rows).

    Failure direction matters: unknown values must never make two
    *different* designs collide.  Past the recursion bound, and for
    objects with no content-based handling, we hash ``repr`` — plain
    containers stay content-addressed, and an object whose repr embeds
    its address merely produces an unstable key (a safe cache miss, never
    a false hit).  Default-``__repr__`` instances are recursed through
    ``vars()`` so ordinary config objects captured by closures still hash
    by content.

    Containers (list/tuple/dict) hash *Merkle-style*: the parent stream
    receives the sha256 digest of the container's own content stream.
    That makes ``memo`` — an optional per-top-level-call ``{(id, depth):
    digest}`` dict — sound: an object shared between modules (one FIFO
    list captured by every module closure) is walked once per design
    instead of once per module.  Memoized and memo-less calls produce
    identical bytes; memo entries must not outlive the hashed objects
    (callers build a fresh memo per design).
    """
    if depth > 8:                        # defensive bound on weird closures
        h.update(b"<deep>")
        h.update(repr(obj).encode())     # still content-based for data
        return
    if type(obj) in _FP_PRIM:
        # exact-type primitive leaf: same bytes the final ``repr`` branch
        # would produce, without walking the isinstance chain
        h.update(repr(obj).encode())
        return
    if isinstance(obj, types.FunctionType):
        def all_names(code):             # incl. nested lambdas/inner defs
            names = set(code.co_names)
            for c in code.co_consts:
                if isinstance(c, types.CodeType):
                    names |= all_names(c)
            return names

        code = obj.__code__
        h.update(b"fn(")
        h.update(code.co_code)
        _fp_update(h, code.co_consts, depth + 1, fifo_depth, memo)
        # every module a factory stamps out shares one code object, so the
        # names repr is worth caching across the design walk
        nkey = (id(code), "conames") if memo is not None else None
        names_b = memo.get(nkey) if nkey is not None else None
        if names_b is None:
            names_b = repr(code.co_names).encode()
            if nkey is not None:
                memo[nkey] = names_b
        h.update(names_b)
        _fp_update(h, obj.__defaults__, depth + 1, fifo_depth, memo)
        _fp_update(h, obj.__kwdefaults__, depth + 1, fifo_depth, memo)
        if obj.__closure__:
            for cell in obj.__closure__:
                try:
                    _fp_update(h, cell.cell_contents, depth + 1, fifo_depth,
                               memo)
                except ValueError:
                    h.update(b"<empty>")
        # module-level state the body reads is design content too (a
        # global `N` changing between builds changes the trace) — also
        # when the read happens inside a nested lambda/inner def; modules
        # hash by name only — importing numpy is not design identity
        g = obj.__globals__
        gkey = (id(code), id(g), "gnames") if memo is not None else None
        if gkey is not None and gkey in memo:
            gnames = memo[gkey]
        else:
            gnames = sorted(all_names(code) & set(g))
            if gkey is not None:
                memo[gkey] = gnames
        # Merkle-wrap the whole globals contribution unconditionally (so
        # the bytes don't depend on whether a memo is in use) and memoize
        # it per (code, globals, depth)
        gdkey = (id(code), id(g), depth, "gdig") if memo is not None else None
        gdig = memo.get(gdkey) if gdkey is not None else None
        if gdig is None:
            gh = hashlib.sha256()
            for name in gnames:
                gh.update(name.encode())
                v = g[name]
                if isinstance(v, types.ModuleType):
                    gh.update(v.__name__.encode())
                else:
                    vkey = (id(v), depth, "g") if memo is not None else None
                    digest = memo.get(vkey) if vkey is not None else None
                    if digest is None:
                        sub = hashlib.sha256()
                        _fp_update(sub, v, depth + 1, fifo_depth, memo)
                        digest = sub.digest()
                        if vkey is not None:
                            memo[vkey] = digest
                    gh.update(digest)
            gdig = gh.digest()
            if gdkey is not None:
                memo[gdkey] = gdig
        h.update(gdig)
        h.update(b")")
    elif isinstance(obj, types.CodeType):
        h.update(b"code(")
        h.update(obj.co_code)
        _fp_update(h, obj.co_consts, depth + 1, fifo_depth, memo)
        h.update(repr(obj.co_names).encode())
        h.update(b")")
    elif isinstance(obj, Fifo):
        if fifo_depth:
            h.update(f"Fifo({obj.name},{obj.depth})".encode())
        else:
            h.update(f"Fifo({obj.name})".encode())
    elif isinstance(obj, np.ndarray):
        h.update(obj.tobytes())
    elif isinstance(obj, (list, tuple)):
        key = (id(obj), depth) if memo is not None else None
        if key is not None and key in memo:
            h.update(memo[key])
            return
        if _fp_plain(obj, depth):
            # pure primitive data: one repr is deterministic content —
            # same bytes with or without memo
            data = repr(obj).encode()
            if key is not None:
                memo[key] = data
            h.update(data)
            return
        sub = hashlib.sha256()
        sub.update(b"(" if isinstance(obj, tuple) else b"[")
        for x in obj:
            _fp_update(sub, x, depth + 1, fifo_depth, memo)
            sub.update(b",")
        sub.update(b"]")
        digest = sub.digest()
        if key is not None:
            memo[key] = digest
        h.update(digest)
    elif isinstance(obj, dict):
        key = (id(obj), depth) if memo is not None else None
        if key is not None and key in memo:
            h.update(memo[key])
            return
        sub = hashlib.sha256()
        sub.update(b"{")
        for k in obj:
            _fp_update(sub, k, depth + 1, fifo_depth, memo)
            sub.update(b":")
            _fp_update(sub, obj[k], depth + 1, fifo_depth, memo)
        sub.update(b"}")
        digest = sub.digest()
        if key is not None:
            memo[key] = digest
        h.update(digest)
    elif type(obj).__repr__ is object.__repr__:
        # default repr would embed the instance address (a new key on
        # every call of the design function — the cache would never hit):
        # hash the class plus the attribute dict by content instead
        h.update(type(obj).__qualname__.encode())
        try:
            _fp_update(h, vars(obj), depth + 1, fifo_depth, memo)
        except TypeError:                # __slots__ etc.: accept misses
            h.update(repr(obj).encode())
    else:
        h.update(repr(obj).encode())


def module_content_hash(fn, fifo_depth: bool = True,
                        memo: Optional[dict] = None) -> str:
    """Content hash of one module generator function (sha256 hex digest).

    Hashes bytecode + constants + defaults + closure contents + referenced
    globals via :func:`_fp_update`.  ``fifo_depth`` selects how captured
    FIFOs enter the hash: ``True`` by name+depth, ``False`` by name only.
    ``memo`` is a per-design shared-capture digest cache (see
    :func:`_fp_update`); all modules of one design must share one memo per
    flavor.
    """
    h = hashlib.sha256()
    _fp_update(h, fn, fifo_depth=fifo_depth, memo=memo)
    return h.hexdigest()


def program_fingerprint(program: Program) -> str:
    """Stable content-addressed key of a design (sha256 hex digest).

    Module bodies are pure and re-runnable by the :class:`Program`
    contract, so the base simulation, the compiled graph and every
    ``resimulate``/``resimulate_batch`` verdict derived from them are a
    pure function of what this fingerprint hashes: FIFO names/depths plus
    each module generator's bytecode, constants, defaults, captured closure
    values and referenced globals.  Equal fingerprints ⇒ interchangeable
    base runs, the guarantee the sweep service's warm cache
    (:class:`repro_torch.sweep.cache.GraphCache`) needs to serve repeat
    requests for a design without re-simulating anything.

    The key composes per-FIFO ``(name, depth)`` rows with per-module
    depth-insensitive content digests (:func:`module_content_hash` with
    ``fifo_depth=False``): the depth vector is hashed exactly once, through
    the FIFO rows, not once per capturing module.
    """
    h = hashlib.sha256()
    h.update(program.name.encode())
    for f in program.fifos:
        h.update(b"|F")
        _fp_update(h, f)
    memo: dict = {}      # shared captures (e.g. one FIFO list) hash once
    for m in program.modules:
        h.update(b"|M")
        h.update(m.name.encode())
        h.update(module_content_hash(m.fn, fifo_depth=False,
                                     memo=memo).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# CompiledGraph bridge: incremental/DSE reuse without graph re-interpretation
# ---------------------------------------------------------------------------
def to_compiled_graph(ct: CompiledTrace):
    """Build the incremental-resimulation cache directly from the trace.

    The returned :class:`~repro_torch.core.incremental.CompiledGraph` is what
    ``compile_graph(engine)`` would have extracted by walking the Python
    node objects of a generator-path run — chains, SEQ weights, RAW edges,
    per-FIFO event arrays (all writes blocking: the compiled path carries
    no NB accesses) and an empty constraint set.  ``simulate_traced``
    installs it as the engine's ``_incr_cache``, so the first
    ``resimulate``/``resimulate_batch`` call skips re-interpretation.
    """
    from .incremental import CompiledGraph
    # CompiledGraph arrays are immutable by contract (consumers — the
    # solvers, dse._batch_arrays and its segment table, the device
    # transfers, the sweep cache — only read or build permuted copies),
    # so the graph *shares* the trace's arrays rather than copying them.
    # Chains are slices of one arange for the same reason.
    fifos = [(w, r, np.ones(len(w), dtype=bool))
             for w, r in zip(ct.fifo_w_nodes, ct.fifo_r_nodes)]
    ids = np.arange(ct.n, dtype=np.int64)
    z = np.zeros(0, np.int64)
    return CompiledGraph(
        n=ct.n,
        raw_dst=ct.raw_dst,
        raw_src=ct.raw_src,
        raw_w=np.ones(len(ct.raw_dst), np.int64),
        base=ct.base,
        chains=[ids[lo:hi] for (lo, hi) in ct.slices],
        seq_w=ct.seq_w,
        fifos=fifos,
        c_kind=z, c_fifo=z, c_seq=z, c_src=z,
        c_out=np.zeros(0, dtype=bool),
    )


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------
def simulate_traced(program: Program,
                    max_steps: int = 50_000_000) -> SimResult:
    """Record, compile and replay ``program`` — the trace-compiled initial
    simulation (paper Sec. 5.1).

    Returns a :class:`~repro_torch.core.program.SimResult` interchangeable with
    the generator engine's (same outputs, cycles, FIFO tables, graph and
    incremental-resimulation behavior) with ``engine="omnisim-trace"``.
    Raises :class:`TraceUnsupported` when the design needs the generator
    path (live NB accesses/probes, deadlocks, SPSC violations); callers
    normally go through ``repro_torch.core.simulate(..., trace="auto")`` which
    handles the fallback.
    """
    rec = record_trace(program, max_steps)
    ct = compile_trace(rec, len(program.fifos))
    depths = program.depths()
    war_dst, war_src = ct.war_edges(depths)
    times, sweeps = _solve_times(ct, war_dst, war_src)
    return build_traced_result(program, rec, ct, times, war_dst, war_src,
                               sweeps)


def build_traced_result(program: Program, rec: RecordedTrace,
                        ct: CompiledTrace, times: np.ndarray,
                        war_dst: np.ndarray, war_src: np.ndarray,
                        sweeps: int) -> SimResult:
    """Assemble the trace path's :class:`SimResult` + engine shell.

    Used by :func:`simulate_traced` (cold record; the reference's delta
    patch shares it for spliced re-records): given a solved trace, build an
    engine shell so downstream consumers (incremental, DSE, taxonomy,
    ``kernels.maxplus.ops.finalize_times``) see exactly the generator
    engine's end state.
    """
    depths = program.depths()
    cycles = int(times.max()) if ct.n else 0
    from .engine import OmniSim
    engine = OmniSim(program, _fifo_shells=True)
    engine.outputs = dict(rec.outputs)
    module_arr = np.empty(ct.n, dtype=np.int64)
    for m, (lo, hi) in enumerate(ct.slices):
        module_arr[lo:hi] = m
    engine.graph = TraceSimGraph(ct, times, war_dst, war_src, module_arr)
    for f in program.fifos:
        tbl = engine.fifos[f.fid]
        w_nodes = ct.fifo_w_nodes[f.fid]
        r_nodes = ct.fifo_r_nodes[f.fid]
        # share the trace's node arrays: the tables never write below
        # ``_nw``/``_nr`` (growth reallocates), so no copy is needed
        tbl._w_nodes = np.asarray(w_nodes, dtype=np.int64)
        tbl._w_times = times[w_nodes]
        tbl._nw = len(w_nodes)
        tbl._r_nodes = np.asarray(r_nodes, dtype=np.int64)
        tbl._r_times = times[r_nodes]
        tbl._nr = len(r_nodes)
        tbl.values.extend(rec.leftovers[f.fid])
        if len(w_nodes):
            engine._writer_of[f.fid] = int(ct.fifo_wmod[f.fid])
        if len(r_nodes):
            engine._reader_of[f.fid] = int(ct.fifo_rmod[f.fid])
    stats = engine.stats
    # the generator engine counts nodes in _new_node, which START bypasses
    stats.nodes = ct.n - ct.n_modules
    stats.edges = engine.graph.n_edges
    stats.resumes = rec.activations          # scheduler (re)activations
    stats.skipped_probes = rec.skipped_probes
    stats.quiescence_rounds = sweeps
    engine._incr_cache = to_compiled_graph(ct)
    engine._trace = rec.periodize()          # compact steady-state storage
    return SimResult(
        program=program.name,
        outputs=dict(rec.outputs),
        cycles=cycles,
        engine="omnisim-trace",
        stats=stats,
        graph=engine,
        constraints=[],
        depths=depths,
    )


# ===========================================================================
# Hybrid trace compilation for dynamic (NB/probe) designs — paper Sec. 5.1
# ===========================================================================
# The straight-line replay above bails out the moment a module issues a live
# non-blocking access or status probe, because the op stream past that point
# is cycle-dependent.  The hybrid engine below keeps the same flat-array
# machinery but segments each module's op stream at its *query points*:
#
#   * **blocking segments** (the ops between two queries) are recorded as
#     flat (kind, fifo, gap, seq) rows exactly like :func:`record_trace` and
#     timed array-at-a-time;
#   * **query points** drop to the generator protocol of ``core/engine.py``:
#     the query's source cycle is the (now solved) chain time, the verdict
#     comes from the committed per-FIFO time tables (paper Table 2), and an
#     unresolvable stuck state applies the earliest-query forced-false rule
#     (paper Sec. 7.1) — sound here too, because every event that is still
#     untimed at a stuck state transitively waits on some pending query and
#     therefore commits strictly after the earliest priced query's cycle.
#
# Three solvers cooperate on the timing side:
#
#   * **Scalar/windowed frontier** (:meth:`HybridSim._advance_frontier`):
#     advances one module's maximal ready prefix, row by row or in
#     geometrically growing numpy windows.  It stops at the first row whose
#     RAW/WAR source is not yet *timed*, so tightly-coupled pipelines make
#     it ping-pong between modules in FIFO-depth-sized hops.
#   * **Provisional-times batch solver** (:meth:`HybridSim._solve_batch`):
#     when enough rows are pending, every module's pending window is solved
#     *simultaneously* — chains are truncated at rows whose source event is
#     not even recorded yet (the writer/reader is parked at a query), cross
#     edges between the provisional windows are materialized, and the same
#     per-chain ``t = cw + cummax(c - cw)`` Gauss-Seidel sweep as
#     :func:`_solve_times` runs to fixpoint over the whole window.  The
#     truncation is what validates the committed prefix: a row inside it
#     depends only on committed times or on rows of the same window, so the
#     fixpoint times are final.  Non-convergence (times growing past the
#     acyclic bound — a WAR cycle, i.e. a genuine deadlock under these
#     depths) commits nothing and defers to the scalar frontier, which
#     stalls and lets ``run()`` raise :class:`TraceUnsupported` so the
#     generator engine reports the paper-exact stall cycle.
#   * **Query periodization** (:meth:`HybridSim._burst_polls`): a steady-
#     state poll loop — the same query site failing with the same period and
#     no commits in between, e.g. ``fig2_timer``'s done-polling timer —
#     needs no per-query machinery at all.  Once the per-module detector
#     (:meth:`HybridSim._apply_query`) sees ``_POLL_STREAK`` consecutive
#     periodic failures, the K future outcomes that are *definitively*
#     false against the committed tables (the target event's commit time is
#     immutable, so ``(lim - t0) // p`` verdicts are known at once —
#     Table 2 vectorized over the window) are resolved in one burst: rows,
#     times and constraints are appended in bulk and the generator is
#     resumed in a tight verification loop that falls back to per-query
#     interpretation the moment a yield diverges from the recorded pattern
#     (different site, different gap, or a non-timing op).  Undecidable
#     outcomes never burst (``K = 0`` when the target event is uncommitted),
#     so the earliest-query forced-false rule is preserved verbatim.
#
# The result is bit-identical to the generator engine (same graph, times,
# FIFO tables, constraints and stats.{nodes,edges,queries}) because both
# engines compute the same unique fixpoint: every resolution is made against
# final committed times, and forced-false resolutions are only applied when
# no event can still commit before the query's cycle.
#
# Segment memoization (:class:`HybridCache`): module bodies are pure and
# re-runnable (the DSL contract), so a module's yield stream is a
# deterministic function of the values sent into it (read values + query
# outcomes).  A completed run therefore caches, per module, the full
# yield-level stream; later runs of the *same design shape* (e.g.
# ``classify_dynamic``'s repeated builder calls under perturbed depths)
# replay the cached stream without ever invoking the generator, validating
# every read value and query outcome against live state.  Validated blocking
# segments replay array-at-a-time (:class:`_RunArrays`,
# :meth:`HybridSim._replay_cached_bulk`): the cached yield stream is
# compiled once into flat row arrays and a window of rows is committed per
# step after a single per-FIFO value check, instead of re-dispatching every
# yield through Python.  On divergence the engine first looks for another
# cached branch whose prefix re-converges with the live outcome, and only
# then materializes the real generator, fast-forwarding it with the
# already-delivered send values.

# module states
_H_READY, _H_PARK_READ, _H_PARK_QUERY, _H_DONE = 0, 1, 2, 3

# query codes
_QC_READ_NB, _QC_WRITE_NB, _QC_EMPTY, _QC_FULL = 0, 1, 2, 3
_QC_IS_READ_SIDE = (True, False, True, False)
_QC_TO_RTYPE = (RequestType.FIFO_NB_READ, RequestType.FIFO_NB_WRITE,
                RequestType.FIFO_CAN_READ, RequestType.FIFO_CAN_WRITE)

# yield-op classes -> row opcodes, for fast-forward verification
_CLS_TO_OP = {Read: OP_READ, Write: OP_WRITE, ReadNB: OP_READ_NB,
              WriteNB: OP_WRITE_NB, Empty: OP_EMPTY, Full: OP_FULL,
              Delay: OP_DELAY, Emit: OP_EMIT}

# query-op lookups for the recorder's hot dispatch loops
_OP_TO_QC = {OP_READ_NB: _QC_READ_NB, OP_WRITE_NB: _QC_WRITE_NB,
             OP_EMPTY: _QC_EMPTY, OP_FULL: _QC_FULL}
_CLS_TO_QC = {ReadNB: _QC_READ_NB, WriteNB: _QC_WRITE_NB,
              Empty: _QC_EMPTY, Full: _QC_FULL}

_VEC_MIN = 48          # pending-slice length above which the solver vectorizes
_BATCH_MIN = 128       # total pending rows above which _solve_batch engages
_POLL_STREAK = 3       # periodic failures before query periodization kicks in
_CACHE_BULK_MIN = 4    # cached-row window length worth array dispatch
_PARK_VEC_MIN = 24     # parked-query count above which pricing vectorizes


class _GrowBuf:
    """Amortized-doubling int64 append buffer (per-FIFO committed times)."""

    __slots__ = ("a", "n")

    def __init__(self):
        self.a = np.empty(16, dtype=np.int64)
        self.n = 0

    def append(self, v: int) -> None:
        if self.n == len(self.a):
            self.a = np.concatenate([self.a, self.a])
        self.a[self.n] = v
        self.n += 1

    def extend(self, vals: np.ndarray) -> None:
        need = self.n + len(vals)
        if need > len(self.a):
            cap = len(self.a)
            while cap < need:
                cap *= 2
            b = np.empty(cap, dtype=np.int64)
            b[:self.n] = self.a[:self.n]
            self.a = b
        self.a[self.n:need] = vals
        self.n = need


@dataclass
class _CachedRun:
    """One module's completed yield-level stream (see :class:`HybridCache`).

    ``ylog[i]`` is the i-th yielded op as ``(opcode, fifo_id, payload)``;
    ``sends[i]`` is the value sent into the generator to resume after yield
    ``i``.  Payloads: Read -> value read, Write -> value written,
    ReadNB -> (ok, value), WriteNB -> (ok, value), Empty/Full -> verdict
    bool (pre-negation), Delay -> cycles, Emit -> (key, value), dead probe
    -> None.  ``arr`` is the lazily-built :class:`_RunArrays` compilation of
    the stream for array-at-a-time replay (identity-compared: two runs with
    the same ylog are the same run regardless of compilation state).
    """

    ylog: list
    sends: list
    arr: Any = field(default=None, repr=False, compare=False)


class _RunArrays:
    """A cached run's yield stream compiled to flat row arrays.

    Built once per :class:`_CachedRun` (lazily, on first bulk replay) and
    shared by every subsequent replay of that branch.  The stream is lowered
    exactly like :func:`record_trace` lowers a live generator: committing
    blocking accesses become *rows* (delays and dead probes fold into the
    row's ``gap``, ``Emit``\\ s are kept aside with their positions), query
    yields become *stop events* that bound the bulk-replayable windows.
    Because each FIFO side belongs to a single module (SPSC), the per-FIFO
    sequence numbers of a from-scratch replay are deterministic and are
    precomputed in ``row_seq``.
    """

    __slots__ = ("ev_pos", "ev_rowidx", "next_q", "boundary",
                 "row_code", "row_fifo", "row_gap", "row_seq", "row_pos",
                 "row_probes_cum", "read_fifos", "write_fifos",
                 "rrow_of", "rvals_of", "wrow_of", "wvals_of",
                 "emit_pos", "emit_kv")

    def __init__(self, ylog: list):
        ev_pos: list = []
        ev_rowidx: list = []
        row_code: list = []
        row_fifo: list = []
        row_gap: list = []
        row_seq: list = []
        row_pos: list = []
        row_probes: list = []
        emit_pos: list = []
        emit_kv: list = []
        rrow_of: Dict[int, list] = {}
        rvals_of: Dict[int, list] = {}
        wrow_of: Dict[int, list] = {}
        wvals_of: Dict[int, list] = {}
        rcnt: Dict[int, int] = {}
        wcnt: Dict[int, int] = {}
        boundary = np.zeros(len(ylog) + 1, dtype=bool)
        boundary[0] = True
        gap, probes = 1, 0
        for pos, (code, f, payload) in enumerate(ylog):
            if code == OP_DELAY:
                gap += payload
            elif code == OP_EMIT:
                emit_pos.append(pos)
                emit_kv.append(payload)
            elif code == OP_PROBE_DEAD:
                gap += 1
                probes += 1
            elif code == OP_READ or code == OP_WRITE:
                boundary[pos + 1] = True
                ev_pos.append(pos)
                ev_rowidx.append(len(row_code))
                row_code.append(code)
                row_fifo.append(f)
                row_gap.append(gap)
                row_pos.append(pos)
                row_probes.append(probes)
                if code == OP_READ:
                    s = rcnt.get(f, 0) + 1
                    rcnt[f] = s
                    rrow_of.setdefault(f, []).append(len(row_code) - 1)
                    rvals_of.setdefault(f, []).append(payload)
                else:
                    s = wcnt.get(f, 0) + 1
                    wcnt[f] = s
                    wrow_of.setdefault(f, []).append(len(row_code) - 1)
                    wvals_of.setdefault(f, []).append(payload)
                row_seq.append(s)
                gap, probes = 1, 0
            else:                     # query yield: bounds the bulk window
                boundary[pos + 1] = True
                ev_pos.append(pos)
                ev_rowidx.append(-1)
                gap, probes = 1, 0
        self.ev_pos = np.asarray(ev_pos, dtype=np.int64)
        self.ev_rowidx = np.asarray(ev_rowidx, dtype=np.int64)
        # next query event at-or-after each event index (len(ev) = none)
        nq = np.empty(len(ev_pos) + 1, dtype=np.int64)
        nq[len(ev_pos)] = len(ev_pos)
        for i in range(len(ev_pos) - 1, -1, -1):
            nq[i] = i if ev_rowidx[i] < 0 else nq[i + 1]
        self.next_q = nq
        self.boundary = boundary
        self.row_code = row_code
        self.row_fifo = row_fifo
        self.row_gap = row_gap
        self.row_seq = row_seq
        self.row_pos = np.asarray(row_pos, dtype=np.int64)
        self.row_probes_cum = np.concatenate(
            [[0], np.cumsum(np.asarray(row_probes, dtype=np.int64))])
        self.read_fifos = sorted(rrow_of)
        self.write_fifos = sorted(wrow_of)
        self.rrow_of = {f: np.asarray(v, dtype=np.int64)
                        for f, v in rrow_of.items()}
        self.rvals_of = rvals_of
        self.wrow_of = {f: np.asarray(v, dtype=np.int64)
                        for f, v in wrow_of.items()}
        self.wvals_of = wvals_of
        self.emit_pos = np.asarray(emit_pos, dtype=np.int64)
        self.emit_kv = emit_kv


class _FullRun:
    """One design's complete solved run, cached for bulk verified replay.

    Stored by :meth:`HybridSim._finish` under the design's *content*
    fingerprint (:func:`program_fingerprint` — FIFO names/depths plus
    module bytecode, constants and closure values), so two designs share
    an entry only when their generators are guaranteed to replay the same
    yield streams.  A warm hit replays the whole run without touching a
    single generator: every module's row arrays and committed times are
    installed in bulk, then *verified* per entry against the claimed
    tables (each row's time must equal ``max(chain, source + 1)`` and
    each query outcome must match the Table-2 verdict it claims — the
    dependency graph of a completed run is acyclic, so pointwise
    fixpoint equality pins the unique solution).  Any mismatch rejects
    the entry and falls back to the exact engine protocol.
    """

    __slots__ = ("kind", "fifo", "gap", "seq", "times", "end_gap", "cons",
                 "outputs", "leftover", "reader_of", "writer_of", "stats",
                 "n_rows")

    def __init__(self, kind, fifo, gap, seq, times, end_gap, cons, outputs,
                 leftover, reader_of, writer_of, stats, n_rows):
        self.kind = kind              # per-module int64 row-opcode arrays
        self.fifo = fifo              # per-module row fifo ids
        self.gap = gap                # per-module row gaps
        self.seq = seq                # per-module 1-based per-FIFO seqs
        self.times = times            # per-module committed times
        self.end_gap = end_gap        # per-module trailing gap
        self.cons = cons              # (n, 6) query/constraint records
        self.outputs = outputs
        self.leftover = leftover      # per-fifo values left in the buffers
        self.reader_of = reader_of
        self.writer_of = writer_of
        self.stats = stats            # semantic counters of the execution
        self.n_rows = n_rows


class HybridCache:
    """Cross-run segment memoization for the hybrid engine.

    Keyed by a depth-insensitive content :meth:`signature` (program name +
    FIFO/module names + per-module bytecode/closure hash) and module id —
    **not** by FIFO depths, which is the point: repeated simulations of
    the same design under perturbed depths (``classify_dynamic``, DSE
    fallbacks) replay cached module streams and re-run generators only
    past a genuine control-flow divergence.  Stores up to ``max_variants``
    outcome branches per module, most recent first.  A second layer keyed
    by the full content fingerprint (depths included) holds complete
    solved runs (:class:`_FullRun`) for bulk verified replay.

    Counters: ``hits`` (modules fully replayed without touching their
    generator), ``misses`` (no cached branch at run start), ``switches``
    (divergence repaired by another cached branch whose prefix re-converges)
    and ``divergences`` (generator materialized and fast-forwarded);
    ``full_hits`` / ``full_misses`` / ``full_rejects`` count the
    whole-run layer.
    """

    def __init__(self, max_variants: int = 6, max_full: int = 8):
        self.max_variants = max_variants
        self.max_full = max_full
        self._runs: Dict[tuple, List[_CachedRun]] = {}
        self._full: "OrderedDict[str, _FullRun]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.switches = 0
        self.divergences = 0
        self.full_hits = 0            # whole runs replayed + verified in bulk
        self.full_misses = 0
        self.full_rejects = 0         # entries that failed verification

    @staticmethod
    def signature(program: Program) -> tuple:
        """Depth-insensitive content key for the segment/variant cache.

        Names alone are NOT enough: two builds of the same design with
        different *builder arguments* (``branch(96)`` vs ``branch(160)``)
        share every name, and a cached yield stream from one would replay
        outcome-compatibly on the other right up to its early end — the
        shorter run's results, silently.  Hashing each module's bytecode +
        constants + captured closure values pins the control flow; FIFO
        depths are deliberately excluded (captured FIFOs hash by name
        only), because depth perturbations are exactly the reuse this
        cache serves — divergence checking handles depth-induced outcome
        changes, but it cannot see closure constants that shorten a loop.
        """
        import hashlib
        h = hashlib.sha256()
        for m in program.modules:
            h.update(m.name.encode())
            h.update(b"|")
            _fp_update(h, m.fn, fifo_depth=False)
        return (program.name,
                tuple(f.name for f in program.fifos),
                tuple(m.name for m in program.modules),
                h.hexdigest())

    def lookup(self, sig: tuple, mid: int) -> List[_CachedRun]:
        return self._runs.get((sig, mid), [])

    def store(self, sig: tuple, mid: int, run: _CachedRun) -> None:
        runs = self._runs.setdefault((sig, mid), [])
        runs.insert(0, run)
        del runs[self.max_variants:]

    def promote(self, sig: tuple, mid: int, run: _CachedRun) -> None:
        runs = self._runs.get((sig, mid), [])
        if run in runs and runs[0] is not run:
            runs.remove(run)
            runs.insert(0, run)

    def lookup_full(self, key: str) -> Optional[_FullRun]:
        run = self._full.get(key)
        if run is None:
            self.full_misses += 1
            return None
        self._full.move_to_end(key)
        return run

    def store_full(self, key: str, run: _FullRun) -> None:
        self._full[key] = run
        self._full.move_to_end(key)
        while len(self._full) > self.max_full:
            self._full.popitem(last=False)

    def peek_full(self, key: str) -> Optional[_FullRun]:
        """Non-counting, non-LRU-touching read — the sweep cache spills
        verified whole-run entries alongside its ``CacheEntry`` without
        perturbing hit/miss stats (``sweep/cache.py``)."""
        return self._full.get(key)


class _HMod:
    """Per-module recorder state of the hybrid engine."""

    __slots__ = ("mid", "name", "gen", "started", "state", "send",
                 "kind", "fifo", "gap", "seq", "times", "gap_acc", "end_gap",
                 "park_fid", "qid", "q_code", "q_fifo", "q_seq", "q_payload",
                 "q_time", "cand", "cand_alts", "pos", "ylog", "sends",
                 "p_code", "p_fifo", "p_seq", "p_gap", "p_row", "streak",
                 "burst", "pending_op", "p_hist", "pat", "pat_k")

    def __init__(self, mid: int, name: str):
        self.mid = mid
        self.name = name
        self.gen = None
        self.started = False
        self.state = _H_READY
        self.send = None
        self.kind: list = []          # row opcodes
        self.fifo: list = []          # row fifo ids (-1 for none)
        self.gap: list = []           # SEQ gap into each row (cycles)
        self.seq: list = []           # 1-based per-FIFO seq (prospective for
                                      # failed NB / probes)
        self.times: list = []         # committed times; len == solve frontier
        self.gap_acc = 1
        self.end_gap = 1
        self.park_fid = -1
        self.qid = -1
        self.q_code = -1
        self.q_fifo = -1
        self.q_seq = -1
        self.q_payload = None
        self.q_time = -1
        self.cand: Optional[_CachedRun] = None
        self.cand_alts: List[_CachedRun] = []
        self.pos = 0                  # next yield index (cache replay)
        self.ylog: Optional[list] = None
        self.sends: Optional[list] = None
        # poll-loop detector (query periodization): last failed query's
        # site/gap/row and the length of the current periodic failure streak
        self.p_code = -1
        self.p_fifo = -1
        self.p_seq = -1
        self.p_gap = -1
        self.p_row = -2
        self.streak = 0
        self.burst = False            # detector armed a burst attempt
        self.pending_op = None        # yield fetched but not yet dispatched
        # generalized periodic-pattern detector: recent consecutive NB query
        # steps (code, fifo, gap, outcome), the armed repeating pattern
        # tuple, and the index of the next expected step within it
        self.p_hist: list = []
        self.pat: Optional[tuple] = None
        self.pat_k = 0


class HybridSim:
    """Segmented trace-compiled simulation of dynamic (NB/probe) designs.

    One instance = one run.  See the section comment above for the
    algorithm; :func:`simulate_hybrid` is the front door.  Raises
    :class:`TraceUnsupported` on true deadlocks, WAR cycles and SPSC
    violations so ``simulate(..., trace="auto")`` can reproduce the
    generator engine's exact report.
    """

    def __init__(self, program: Program, cache: Optional[HybridCache] = None,
                 max_steps: int = 50_000_000, periodize: bool = True,
                 batch_min: int = _BATCH_MIN):
        self.program = program
        self.cache = cache
        self.max_steps = max_steps
        self.periodize = periodize
        self.batch_min = batch_min    # <= 0 disables the batch solver
        self.depths = [f.depth for f in program.fifos]
        n_fifo = len(program.fifos)
        self.mods = [_HMod(m.mid, m.name) for m in program.modules]
        self.buffers: List[deque] = [deque() for _ in range(n_fifo)]
        self.fw_times = [_GrowBuf() for _ in range(n_fifo)]  # committed writes
        self.fr_times = [_GrowBuf() for _ in range(n_fifo)]  # committed reads
        self.wseq = [0] * n_fifo      # recorded committed writes per FIFO
        self.rseq = [0] * n_fifo      # recorded committed reads per FIFO
        self.writer_of: Dict[int, int] = {}
        self.reader_of: Dict[int, int] = {}
        self.waiting_reader: Dict[int, int] = {}
        self.outputs: Dict[str, Any] = {}
        self.constraints: list = []   # (q_code, fifo, seq, mid, row, outcome)
        self.heap: List[Tuple[int, int, int]] = []   # (time, qid, mid)
        self.unpriced: set = set()
        self.solve_dirty: set = set()
        self.pending: set = set()     # mids with recorded-but-untimed rows
        self.n_done = 0               # modules in _H_DONE state
        # parked-query watch slots: a read-side query's verdict can only
        # flip when its FIFO's *write* table grows (and vice versa), and
        # SPSC means at most one parked query watches each (fifo, side) —
        # so every commit site can wake exactly the right parked queries
        # and quiescence never rescans a heap nothing could have changed
        self.qwatch_w = [-1] * n_fifo   # parked read-side query mid per fifo
        self.qwatch_r = [-1] * n_fifo   # parked write-side query mid per fifo
        self.rp_wake: set = set()       # parked mids whose table grew
        self.runq: deque = deque()
        self.queued = [False] * len(self.mods)
        self._qid = 0
        self.steps = 0
        self.activations = 0
        self.phases = 0
        self.queries = 0
        self.forced = 0
        self.skipped_probes = 0
        self.bulk_queries = 0         # queries resolved by periodized bursts
        self.bursts = 0
        self.batch_rows = 0           # rows committed by the batch solver
        self.batch_solves = 0
        self._batch_futile = -1       # pending volume of the last no-commit
        #                               batch attempt (futility gate)
        self._batch_backoff = 0       # pending volume below which the batch
        #                               solver stays off (low-yield backoff)
        self.cache_bulk_rows = 0      # cached rows replayed array-at-a-time
        self._full_replay = False     # this run was served by _replay_full
        if cache is not None:
            self.sig = HybridCache.signature(program)
            # full content fingerprint for whole-run replay: the segment
            # signature above deliberately ignores FIFO depths (divergence
            # checking absorbs depth-induced outcome changes), but a bulk
            # replay installs committed *times*, which depend on depths —
            # its key must pin them too
            self._fkey = program_fingerprint(program)
            for st in self.mods:
                st.ylog, st.sends = [], []
                st.cand_alts = cache.lookup(self.sig, st.mid)
                if st.cand_alts:
                    st.cand = st.cand_alts[0]
                else:
                    cache.misses += 1

    # ----------------------------------------------------------------- utils
    def _unsup(self, msg: str) -> TraceUnsupported:
        return TraceUnsupported(f"{self.program.name}: {msg}")

    def _check_endpoint(self, f: int, mid: int, write_side: bool) -> None:
        table = self.writer_of if write_side else self.reader_of
        prev = table.setdefault(f, mid)
        if prev != mid:
            raise self._unsup(
                f"fifo {f} has two {'writer' if write_side else 'reader'} "
                f"modules — SPSC violation; deferring to the generator "
                f"engine's endpoint check")

    def _enqueue(self, mid: int) -> None:
        if not self.queued[mid]:
            self.queued[mid] = True
            self.runq.append(mid)

    def _mark_dirty(self, mid: int) -> None:
        # only modules with recorded-but-untimed rows can profit from a
        # frontier retry; marking others would just break the empty-dirty
        # fast paths (a module recording new rows later re-enters the
        # worklist through ``self.pending``)
        if mid >= 0:
            st = self.mods[mid]
            if len(st.kind) != len(st.times):
                self.solve_dirty.add(mid)

    # --------------------------------------------------- eager row timing
    # When a module records a blocking row while its chain is timed up to
    # that row (lock-step execution, the forced-poll ping-pong hot case),
    # the row's time is computable immediately from the committed tables —
    # same formula as the frontier, so committing it here instead of
    # waiting for the next ``_solve`` changes nothing but when the work
    # happens.  Rows whose RAW/WAR source is uncommitted simply stay
    # pending and flow through the regular solver.
    def _eager_read(self, st: _HMod, f: int, s: int) -> None:
        wt = self.fw_times[f]
        if s > wt.n:
            return
        times_l = st.times
        t = (times_l[-1] if times_l else 0) + st.gap[-1]
        c = int(wt.a[s - 1]) + 1
        if c > t:
            t = c
        self.fr_times[f].append(t)
        times_l.append(t)
        self._mark_dirty(self.writer_of.get(f, -1))
        w = self.qwatch_r[f]
        if w >= 0:
            self.rp_wake.add(w)

    def _eager_write(self, st: _HMod, f: int, s: int) -> None:
        tg = s - self.depths[f]
        times_l = st.times
        t = (times_l[-1] if times_l else 0) + st.gap[-1]
        if tg > 0:
            rt = self.fr_times[f]
            if tg > rt.n:
                return
            c = int(rt.a[tg - 1]) + 1
            if c > t:
                t = c
        self.fw_times[f].append(t)
        times_l.append(t)
        self._mark_dirty(self.reader_of.get(f, -1))
        w = self.qwatch_w[f]
        if w >= 0:
            self.rp_wake.add(w)

    # ------------------------------------------------------- frontier solver
    def _advance_frontier(self, st: _HMod) -> bool:
        """Time the maximal ready prefix of ``st``'s pending rows.

        Pending rows are always blocking accesses (query rows are committed
        with their resolution time the moment they resolve), so each row's
        time is ``max(t_prev + gap, src + 1)`` with ``src`` the RAW matching
        write (reads) or the WAR target read (writes, seq > depth).  Large
        pending slices go through the vectorized cummax path — the "compile
        the blocking segment" move of paper Sec. 5.1.
        """
        times_l = st.times
        lo, hi = len(times_l), len(st.kind)
        if lo >= hi:
            return False
        kind_l, fifo_l, gap_l, seq_l = st.kind, st.fifo, st.gap, st.seq
        fw, fr, depths = self.fw_times, self.fr_times, self.depths
        t_prev = times_l[lo - 1] if lo else 0
        if hi - lo == 1:
            # exactly one pending row — the write-before-poll / pipeline
            # ping-pong hot case: commit it without touched-set bookkeeping
            f = fifo_l[lo]
            s = seq_l[lo]
            t = t_prev + gap_l[lo]
            if kind_l[lo] == OP_READ:
                wt = fw[f]
                if s > wt.n:
                    return False
                c = int(wt.a[s - 1]) + 1
                if c > t:
                    t = c
                fr[f].append(t)
                self._mark_dirty(self.writer_of.get(f, -1))
                w = self.qwatch_r[f]
            else:                                   # OP_WRITE
                tg = s - depths[f]
                if tg > 0:
                    rt = fr[f]
                    if tg > rt.n:
                        return False
                    c = int(rt.a[tg - 1]) + 1
                    if c > t:
                        t = c
                fw[f].append(t)
                self._mark_dirty(self.reader_of.get(f, -1))
                w = self.qwatch_w[f]
            if w >= 0:
                self.rp_wake.add(w)
            times_l.append(t)
            return True
        touched_w: set = set()
        touched_r: set = set()
        # scalar pass over the first few pending rows: a frontier that
        # advances in FIFO-depth-sized hops (pipeline ping-pong) never pays
        # numpy call overhead
        cap = min(hi, lo + _VEC_MIN)
        i = lo
        while i < cap:
            f = fifo_l[i]
            s = seq_l[i]
            t = t_prev + gap_l[i]
            if kind_l[i] == OP_READ:
                wt = fw[f]
                if s > wt.n:
                    break
                c = int(wt.a[s - 1]) + 1
                if c > t:
                    t = c
                fr[f].append(t)
                touched_r.add(f)
            else:                                   # OP_WRITE
                tg = s - depths[f]
                if tg > 0:
                    rt = fr[f]
                    if tg > rt.n:
                        break
                    c = int(rt.a[tg - 1]) + 1
                    if c > t:
                        t = c
                fw[f].append(t)
                touched_w.add(f)
            times_l.append(t)
            t_prev = t
            i += 1
        if i == cap and cap < hi:
            # long runnable stretch: batch the rest through the vectorized
            # cummax in geometrically growing windows (each window is only
            # materialized as arrays once per visit)
            self._advance_frontier_np(st, hi, touched_r, touched_w)
        if touched_w:
            qw, wake = self.qwatch_w, self.rp_wake
            for f in touched_w:
                self._mark_dirty(self.reader_of.get(f, -1))
                w = qw[f]
                if w >= 0:
                    wake.add(w)
        if touched_r:
            qr, wake = self.qwatch_r, self.rp_wake
            for f in touched_r:
                self._mark_dirty(self.writer_of.get(f, -1))
                w = qr[f]
                if w >= 0:
                    wake.add(w)
        return len(times_l) > lo

    def _advance_frontier_np(self, st: _HMod, hi: int,
                             touched_r: set, touched_w: set) -> None:
        """Windowed vectorized frontier advance: ``t = cw + cummax(c - cw)``
        over the maximal ready prefix, window doubling per round."""
        dep = np.asarray(self.depths, dtype=np.int64)
        window = 2 * _VEC_MIN
        while True:
            lo = len(st.times)
            if lo >= hi:
                return
            w = min(hi - lo, window)
            kind = np.asarray(st.kind[lo:lo + w], dtype=np.int64)
            fifo = np.asarray(st.fifo[lo:lo + w], dtype=np.int64)
            gap = np.asarray(st.gap[lo:lo + w], dtype=np.int64)
            seq = np.asarray(st.seq[lo:lo + w], dtype=np.int64)
            nwt = np.fromiter((b.n for b in self.fw_times), np.int64,
                              len(self.fw_times))
            nrt = np.fromiter((b.n for b in self.fr_times), np.int64,
                              len(self.fr_times))
            rd = kind == OP_READ
            avail = np.empty(w, dtype=bool)
            avail[rd] = seq[rd] <= nwt[fifo[rd]]
            wr = ~rd
            tg = seq[wr] - dep[fifo[wr]]
            avail[wr] = (tg <= 0) | (tg <= nrt[fifo[wr]])
            stop = w if avail.all() else int(np.argmin(avail))
            if stop == 0:
                return
            kind, fifo, gap, seq, rd = (kind[:stop], fifo[:stop], gap[:stop],
                                        seq[:stop], rd[:stop])
            c = np.full(stop, NEGI, dtype=np.int64)
            for f in np.unique(fifo):
                m_r = rd & (fifo == f)
                if m_r.any():
                    c[m_r] = self.fw_times[f].a[seq[m_r] - 1] + 1
                m_w = ~rd & (fifo == f)
                if m_w.any():
                    sw = seq[m_w]
                    con = sw > self.depths[f]
                    if con.any():
                        idx = np.flatnonzero(m_w)[con]
                        c[idx] = (self.fr_times[f].a[sw[con]
                                                     - self.depths[f] - 1] + 1)
            t_prev = st.times[lo - 1] if lo else 0
            cw = t_prev + np.cumsum(gap)
            t = cw + np.maximum.accumulate(np.maximum(c - cw, 0))
            st.times.extend(t.tolist())
            for f in np.unique(fifo):
                m_r = rd & (fifo == f)
                if m_r.any():
                    self.fr_times[f].extend(t[m_r])
                    touched_r.add(f)
                m_w = ~rd & (fifo == f)
                if m_w.any():
                    self.fw_times[f].extend(t[m_w])
                    touched_w.add(f)
            if stop < w:
                return
            window *= 2

    def _solve_batch(self) -> bool:
        """Provisional-times batch solve of every recorded-but-untimed row.

        Replaces the FIFO-depth-sized hops of :meth:`_advance_frontier` on
        tightly-coupled pipelines: every module's pending window enters one
        multi-chain longest-path system (committed times as boundary
        conditions), solved by the same per-chain ``t = cw + cummax(c-cw)``
        Gauss-Seidel sweep as :func:`_solve_times`.  Windows are first
        *truncated* at the earliest row whose RAW/WAR source event is not
        recorded anywhere (its module is parked at a query) — iterated to a
        fixpoint, since truncating a writer window can strand a reader row —
        which is what validates the committed prefix: every surviving row
        depends only on committed times or rows inside the windows.

        Returns True when any row was committed.  Non-convergence (a WAR
        cycle: times grow past the acyclic bound) commits nothing and
        returns False — the scalar frontier then stalls on the cycle and
        ``run()`` reports it as a deadlock via :class:`TraceUnsupported`.
        """
        fw, fr = self.fw_times, self.fr_times
        n_fifo = len(self.depths)
        dep = np.asarray(self.depths, dtype=np.int64)
        fwn = np.fromiter((b.n for b in fw), np.int64, n_fifo)
        frn = np.fromiter((b.n for b in fr), np.int64, n_fifo)
        sts, kinds, fifos, gaps, seqs, t0s = [], [], [], [], [], []
        for mid in sorted(self.pending):
            st = self.mods[mid]
            lo, hi = len(st.times), len(st.kind)
            if lo >= hi:
                continue
            sts.append(st)
            kinds.append(np.asarray(st.kind[lo:], dtype=np.int64))
            fifos.append(np.asarray(st.fifo[lo:], dtype=np.int64))
            gaps.append(np.asarray(st.gap[lo:], dtype=np.int64))
            seqs.append(np.asarray(st.seq[lo:], dtype=np.int64))
            t0s.append(st.times[lo - 1] if lo else 0)
        n_win = len(sts)
        if not n_win:
            return False
        # ---- truncate windows at unrecorded sources (iterated fixpoint)
        e = [len(k) for k in kinds]
        wwin = np.full(n_fifo, -1, dtype=np.int64)   # window holding f's
        rwin = np.full(n_fifo, -1, dtype=np.int64)   # pending writes/reads
        wpos: Dict[int, np.ndarray] = {}
        rpos: Dict[int, np.ndarray] = {}
        for i in range(n_win):
            wr = kinds[i] != OP_READ
            for f in np.unique(fifos[i]):
                m = fifos[i] == f
                pw = np.flatnonzero(m & wr)
                if len(pw):
                    wwin[f] = i
                    wpos[int(f)] = pw
                pr = np.flatnonzero(m & ~wr)
                if len(pr):
                    rwin[f] = i
                    rpos[int(f)] = pr
        for _ in range(4 * n_win + 8):
            avail_w = np.zeros(n_fifo, dtype=np.int64)
            avail_r = np.zeros(n_fifo, dtype=np.int64)
            for f, p in wpos.items():
                avail_w[f] = int(np.searchsorted(p, e[int(wwin[f])]))
            for f, p in rpos.items():
                avail_r[f] = int(np.searchsorted(p, e[int(rwin[f])]))
            changed = False
            for i in range(n_win):
                lim = e[i]
                if not lim:
                    continue
                k, f, s = kinds[i][:lim], fifos[i][:lim], seqs[i][:lim]
                rd = k == OP_READ
                bad = rd & (s > fwn[f] + avail_w[f])
                tg = s - dep[f]
                bad |= ~rd & (tg > 0) & (tg > frn[f] + avail_r[f])
                if bad.any():
                    e[i] = int(np.argmax(bad))
                    changed = True
            if not changed:
                break
        else:
            return False
        if not any(e):
            return False
        # ---- build the provisional system: cw, constant sources, edges
        cws, cs, ts = [], [], []
        buckets: Dict[int, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
        total_gap = 0
        n_edges = 0
        max_committed = 0
        for i in range(n_win):
            lim = e[i]
            k, f, s, g = (kinds[i][:lim], fifos[i][:lim], seqs[i][:lim],
                          gaps[i][:lim])
            cw = t0s[i] + np.cumsum(g)
            c = np.full(lim, NEGI, dtype=np.int64)
            total_gap += int(g.sum())
            max_committed = max(max_committed, t0s[i])
            rd = k == OP_READ
            for fid in np.unique(f):
                fid = int(fid)
                m_r = rd & (f == fid)
                if m_r.any():
                    sv = s[m_r]
                    com = sv <= fwn[fid]
                    if com.any():
                        idx = np.flatnonzero(m_r)[com]
                        c[idx] = fw[fid].a[sv[com] - 1] + 1
                    pend = ~com
                    if pend.any():
                        dst = np.flatnonzero(m_r)[pend]
                        src = wpos[fid][sv[pend] - fwn[fid] - 1]
                        buckets.setdefault(int(wwin[fid]), []).append(
                            (i, src, dst))
                        n_edges += len(dst)
                m_w = ~rd & (f == fid)
                if m_w.any():
                    tg = s[m_w] - int(dep[fid])
                    con = tg > 0
                    com = con & (tg <= frn[fid])
                    if com.any():
                        idx = np.flatnonzero(m_w)[com]
                        c[idx] = fr[fid].a[tg[com] - 1] + 1
                    pend = con & ~com
                    if pend.any():
                        dst = np.flatnonzero(m_w)[pend]
                        src = rpos[fid][tg[pend] - frn[fid] - 1]
                        buckets.setdefault(int(rwin[fid]), []).append(
                            (i, src, dst))
                        n_edges += len(dst)
            if lim:
                # committed sources (incl. from fully-timed modules) push
                # the acyclic bound past the pending modules' own times
                max_committed = max(max_committed, int(c.max()))
            cws.append(cw)
            cs.append(c)
            ts.append(np.full(lim, NEGI, dtype=np.int64))
        # ---- Gauss-Seidel sweep to fixpoint (dirty-window tracking)
        bound = max_committed + total_gap + n_edges + 1
        dirty = [lim > 0 for lim in e]
        sweeps = 0
        while any(dirty):
            sweeps += 1
            if sweeps > n_win + 4:
                if sweeps > sum(e) + 2 or max(
                        (int(t.max()) for t in ts if len(t)),
                        default=0) > bound:
                    return False         # WAR cycle: defer to scalar/deadlock
            for i in range(n_win):
                if not dirty[i]:
                    continue
                dirty[i] = False
                seg = np.maximum(cs[i] - cws[i], 0)
                np.maximum.accumulate(seg, out=seg)
                seg += cws[i]
                if np.array_equal(seg, ts[i]):
                    continue
                ts[i] = seg
                for (di, src, dst) in buckets.get(i, ()):
                    cand = seg[src] + 1
                    old = cs[di][dst]
                    moved = cand > old
                    if moved.any():
                        cs[di][dst] = np.maximum(old, cand)
                        dirty[di] = True
        # ---- commit: everything in the truncated windows is final
        for i in range(n_win):
            lim = e[i]
            if not lim:
                continue
            st, t = sts[i], ts[i]
            st.times.extend(t.tolist())
            k, f = kinds[i][:lim], fifos[i][:lim]
            rd = k == OP_READ
            for fid in np.unique(f):
                fid = int(fid)
                m_r = rd & (f == fid)
                if m_r.any():
                    fr[fid].extend(t[m_r])
                    w = self.qwatch_r[fid]
                    if w >= 0:
                        self.rp_wake.add(w)
                m_w = ~rd & (f == fid)
                if m_w.any():
                    fw[fid].extend(t[m_w])
                    w = self.qwatch_w[fid]
                    if w >= 0:
                        self.rp_wake.add(w)
            self.batch_rows += lim
        self.batch_solves += 1
        return True

    def _solve(self) -> bool:
        """Run the frontier solvers to fixpoint over the dirty-module set.

        Seeds the worklist from ``self.pending`` — the incrementally
        maintained set of modules with recorded-but-untimed rows (updated
        by the run loop after every activation and by ``_issue_query``) —
        so a solve costs O(pending modules), not a scan of every module in
        the design.  Large pending volumes go through the provisional-times
        batch solver first (:meth:`_solve_batch`); the scalar frontier mops
        up the remainder and is the sole path when the batch solver bails
        (WAR cycles).
        """
        dirty = self.solve_dirty
        pend = self.pending
        if not pend and not dirty:
            return False
        mods = self.mods
        pending = 0
        for mid in pend:
            st = mods[mid]
            d = len(st.kind) - len(st.times)
            if d > 0:
                pending += d
                dirty.add(mid)
        changed = False
        # Futility gate: when a batch attempt committed nothing (every
        # window truncated to zero — e.g. most modules parked for good in a
        # deadlocking 1000-module corpus design), re-running it per query
        # at the same pending volume just rebuilds the same system.  The
        # scalar frontier below computes the identical fixpoint in small
        # hops, so skipping the batch can never change results — only
        # which solver commits the rows.
        if (pending >= self.batch_min > 0 and pending != self._batch_futile
                and pending >= self._batch_backoff):
            rows0 = self.batch_rows
            if self._solve_batch():
                changed = True
                self._batch_futile = -1
                got = self.batch_rows - rows0
                # Low-yield backoff: when a large system is rebuilt only to
                # commit a trickle of rows (run-ahead recording throttled by
                # WAR on lazily-committing NB reads), the next attempt at a
                # similar volume rebuilds the same system.  Hold the batch
                # solver off until the pending volume has grown past the
                # uncommitted remainder by a full batch quantum; the scalar
                # frontier commits the trickle at O(rows) in the meantime.
                if got * 4 < pending:
                    self._batch_backoff = pending - got + self.batch_min
                else:
                    self._batch_backoff = 0
            else:
                self._batch_futile = pending
        while dirty:
            st = mods[dirty.pop()]
            if self._advance_frontier(st):
                changed = True
        if pend:
            done = [mid for mid in pend
                    if len(mods[mid].times) == len(mods[mid].kind)]
            for mid in done:
                pend.discard(mid)
        return changed

    # --------------------------------------------------------------- queries
    def _verdict(self, code: int, f: int, s: int, t: int) -> Optional[bool]:
        """Table-2 resolution against the committed time tables; ``None`` =
        target event not yet committed (same rule as FifoTable.can_*_at)."""
        if _QC_IS_READ_SIDE[code]:
            wt = self.fw_times[f]
            if s <= wt.n:
                return bool(wt.a[s - 1] < t)
            return None
        tg = s - self.depths[f]
        if tg <= 0:
            return True
        rt = self.fr_times[f]
        if tg <= rt.n:
            return bool(rt.a[tg - 1] < t)
        return None

    def _apply_query(self, st: _HMod, outcome: bool) -> None:
        """Commit a resolved query at its source cycle ``st.q_time`` —
        the generator engine's ``_apply_query_result``, on flat arrays."""
        code, f, s, t = st.q_code, st.q_fifo, st.q_seq, st.q_time
        row = len(st.kind)
        self.constraints.append((code, f, s, st.mid, row, outcome))
        payload = st.q_payload
        # the query is resolving: retire its (fifo, side) watch slot
        if _QC_IS_READ_SIDE[code]:
            self.qwatch_w[f] = -1
        else:
            self.qwatch_r[f] = -1
        if code == _QC_READ_NB:
            if outcome:
                v = self.buffers[f].popleft()
                st.kind.append(OP_READ_NB)
                self.rseq[f] = s
                self.fr_times[f].append(t)
                w = self.qwatch_r[f]
                if w >= 0:
                    self.rp_wake.add(w)
                self._mark_dirty(self.writer_of.get(f, -1))
                st.send = (True, v)
            else:
                st.kind.append(OP_NB_FAIL)
                st.send = (False, None)
            expected = st.send
        elif code == _QC_WRITE_NB:
            if outcome:
                st.kind.append(OP_WRITE_NB)
                self.wseq[f] = s
                self.fw_times[f].append(t)
                w = self.qwatch_w[f]
                if w >= 0:
                    self.rp_wake.add(w)
                self._mark_dirty(self.reader_of.get(f, -1))
                self.buffers[f].append(payload)
                w = self.waiting_reader.pop(f, None)
                if w is not None:
                    self._enqueue(w)
                st.send = True
            else:
                st.kind.append(OP_NB_FAIL)
                st.send = False
            expected = (outcome, payload)
        else:                                       # Empty / Full probe
            st.kind.append(OP_PROBE)
            st.send = not outcome
            expected = outcome
        st.fifo.append(f)
        st.gap.append(st.gap_acc)
        st.seq.append(s)
        st.times.append(t)
        g = st.gap_acc
        st.gap_acc = 1
        st.q_payload = None
        st.state = _H_READY
        # ---- steady-state periodic-pattern detector (query periodization).
        # Single-site all-fail streaks (>= _POLL_STREAK consecutive failures
        # at one site, same gap, no commits in between) keep the dedicated
        # closed-form burst path (_poll_horizon/_burst_polls).  Everything
        # else that repeats — multi-site poll rotations, steady NB success
        # streams, mixed fail/success periods — arms a generalized pattern
        # tuple of (code, fifo, gap, outcome) steps consumed by
        # _burst_pattern.  Steps must be row-consecutive queries: any
        # blocking row in between resets both detectors.
        if self.periodize:
            consec = row == st.p_row + 1
            st.p_row = row
            if outcome:
                st.streak = 0
            elif (consec and code == st.p_code and f == st.p_fifo
                    and s == st.p_seq and g == st.p_gap):
                st.streak += 1
                if st.streak >= _POLL_STREAK and st.pat is None:
                    st.burst = True
            else:
                st.p_code, st.p_fifo, st.p_seq, st.p_gap = code, f, s, g
                st.streak = 1
            if code <= _QC_WRITE_NB:
                step = (code, f, g, outcome)
                pat = st.pat
                hist = st.p_hist
                if pat is not None and consec:
                    if step == pat[st.pat_k]:
                        k2 = st.pat_k + 1
                        if k2 == len(pat):
                            st.pat_k = 0
                            st.burst = True
                        else:
                            st.pat_k = k2
                    else:                     # pattern broke: re-detect
                        st.pat = None
                        hist.clear()
                        hist.append(step)
                else:
                    if pat is not None:       # non-consecutive row: disarm
                        st.pat = None
                        hist.clear()
                    elif not consec:
                        hist.clear()
                    hist.append(step)
                    L = len(hist)
                    if L > 12:                # 3 periods of the max P == 4
                        del hist[0]
                        L = 12
                    for P in (1, 2, 3, 4):    # arm the shortest period seen
                        if L < 3 * P:         # need 3 observed periods
                            break
                        for i in range(1, 2 * P + 1):
                            if hist[-i] != hist[-i - P]:
                                break
                        else:
                            if P == 1 and not outcome:
                                break         # single-site all-fail: streak
                            st.pat = tuple(hist[-P:])
                            st.pat_k = 0
                            st.burst = True
                            break
            elif st.pat is not None or st.p_hist:
                st.pat = None                 # used probes break NB patterns
                st.p_hist.clear()
        op_code = (OP_READ_NB, OP_WRITE_NB, OP_EMPTY, OP_FULL)[code]
        if st.cand is not None:
            want = (st.cand.ylog[st.pos][2]
                    if st.pos < len(st.cand.ylog) else None)
            if want == expected:
                st.pos += 1
            else:
                self._diverge(st, (op_code, f, expected), st.send)
        elif st.ylog is not None:
            st.ylog.append((op_code, f, expected))
            st.sends.append(st.send)

    # ------------------------------------------------- query periodization
    def _poll_horizon(self, st: _HMod) -> int:
        """Number of future polls of ``st``'s detected loop that resolve
        *definitively false* against the committed time tables.

        Paper Table 2, vectorized over the periodic window: the k-th future
        poll prices at ``t0 + k*p`` and fails while that cycle is <= the
        (immutable) commit time of the target event, so the whole window of
        verdicts is ``(lim - t0) // p`` — known at once, with no per-query
        resolution.  Returns 0 when the target event is uncommitted (the
        verdict would be undecidable: the forced-false rule must keep
        handling it) or when the loop could succeed immediately.
        """
        code, f, s = st.q_code, st.q_fifo, st.q_seq
        p = st.p_gap
        if p <= 0:
            return 0
        if _QC_IS_READ_SIDE[code]:
            wt = self.fw_times[f]
            if s > wt.n:
                return 0
            lim = int(wt.a[s - 1])
        else:
            tg = s - self.depths[f]
            if tg <= 0:
                return 0
            rt = self.fr_times[f]
            if tg > rt.n:
                return 0
            lim = int(rt.a[tg - 1])
        return (lim - st.times[-1]) // p

    def _burst_polls(self, st: _HMod, K: int) -> bool:
        """Resolve up to ``K`` periodic poll outcomes in one burst.

        The module has just had a failed query resolved at its detected
        poll site; all of the next ``K`` polls are known to fail
        (:meth:`_poll_horizon`).  Rows, times and constraints are appended
        in bulk while the module's stream (generator or cached branch) is
        advanced through a tight verification loop that admits only the
        recorded pattern — timing-only body ops followed by the same query
        at the same gap.  Any divergence stops the burst *before* the
        off-pattern poll is committed and hands the pending yield back to
        the normal per-query dispatch, so results stay bit-identical.
        Returns True when the module terminated during the burst.
        """
        code, f, s = st.q_code, st.q_fifo, st.q_seq
        p = st.p_gap
        op_code = (OP_READ_NB, OP_WRITE_NB, OP_EMPTY, OP_FULL)[code]
        # failed NB accesses commit as NB_FAIL rows, probes as PROBE rows —
        # exactly what _apply_query records (op_code is the *ylog* encoding)
        row_code = OP_NB_FAIL if code <= _QC_WRITE_NB else OP_PROBE
        if code == _QC_READ_NB:
            fail_send: Any = (False, None)
        elif code == _QC_WRITE_NB:
            fail_send = False
        else:
            fail_send = True              # Empty/Full: send = not outcome
        kind_l, fifo_l, gap_l = st.kind, st.fifo, st.gap
        seq_l, times_l = st.seq, st.times
        cons = self.constraints
        mid = st.mid
        t = times_l[-1]
        k = 0
        if st.cand is not None:
            # cached-branch burst: verify entries, never touch a generator;
            # rows/times/constraints are flushed in bulk after the loop
            ylog = st.cand.ylog
            L = len(ylog)
            pos = st.pos
            probes_total = 0
            while k < K:
                g_extra, probes, npos = 0, 0, pos
                while npos < L:
                    e = ylog[npos]
                    c0 = e[0]
                    if c0 == OP_DELAY:
                        g_extra += e[2]
                    elif c0 == OP_PROBE_DEAD:
                        g_extra += 1
                        probes += 1
                    else:
                        break
                    npos += 1
                if npos >= L:
                    break
                e = ylog[npos]
                if e[0] != op_code or e[1] != f:
                    break
                pay = e[2]
                if code == _QC_READ_NB:
                    if pay != (False, None):
                        break
                elif code == _QC_WRITE_NB:
                    if not (type(pay) is tuple and pay[0] is False):
                        break
                elif pay is not False:
                    break
                if st.gap_acc + g_extra != p:
                    break
                st.gap_acc = 1
                probes_total += probes
                pos = npos + 1
                k += 1
            if k:
                row0 = len(kind_l)
                self.queries += k
                self.skipped_probes += probes_total
                self.steps += pos - st.pos
                cons.extend(zip(repeat(code, k), repeat(f, k), repeat(s, k),
                                repeat(mid, k), range(row0, row0 + k),
                                repeat(False, k)))
                kind_l.extend([row_code] * k)
                fifo_l.extend([f] * k)
                gap_l.extend([p] * k)
                seq_l.extend([s] * k)
                times_l.extend(range(t + p, t + k * p + 1, p))
            st.pos = pos
            st.send = fail_send
        else:
            # live-generator burst: rows/times/constraints are flushed in
            # bulk after the verification loop — the loop itself is only
            # generator resumptions plus pattern checks
            gen = st.gen
            gen_send = gen.send
            log = st.ylog is not None
            send = st.send
            qcls = (ReadNB, WriteNB, Empty, Full)[code]
            stopped = False
            n_send = 0
            budget = self.max_steps - self.steps
            try:
                while k < K:
                    op = gen_send(send)
                    n_send += 1
                    if n_send > budget:
                        raise RuntimeError(
                            f"step budget exceeded ({self.max_steps}); "
                            f"possible livelock — neither OmniSim nor "
                            f"co-sim detects livelock")
                    send = None
                    cls = op.__class__
                    while True:        # timing-only body ops keep the pattern
                        if cls is Delay:
                            st.gap_acc += op.cycles
                            if log:
                                st.ylog.append((OP_DELAY, -1, op.cycles))
                                st.sends.append(None)
                        elif cls is Emit:
                            self.outputs[op.key] = op.value
                            if log:
                                st.ylog.append((OP_EMIT, -1,
                                                (op.key, op.value)))
                                st.sends.append(None)
                        elif (cls is Empty or cls is Full) and not op.used:
                            self.skipped_probes += 1
                            st.gap_acc += 1
                            if log:
                                st.ylog.append((OP_PROBE_DEAD, op.fifo.fid,
                                                None))
                                st.sends.append(None)
                        else:
                            break
                        op = gen_send(None)
                        n_send += 1
                        if n_send > budget:
                            raise RuntimeError(
                                f"step budget exceeded ({self.max_steps}); "
                                f"possible livelock — neither OmniSim nor "
                                f"co-sim detects livelock")
                        cls = op.__class__
                    if (cls is not qcls or op.fifo.fid != f
                            or st.gap_acc != p):
                        st.pending_op = op
                        break
                    st.gap_acc = 1
                    if log:
                        if code == _QC_READ_NB:
                            st.ylog.append((op_code, f, (False, None)))
                        elif code == _QC_WRITE_NB:
                            st.ylog.append((op_code, f, (False, op.value)))
                        else:
                            st.ylog.append((op_code, f, False))
                        st.sends.append(fail_send)
                    send = fail_send
                    k += 1
                else:
                    st.send = fail_send
                if st.pending_op is not None:
                    st.send = None
            except StopIteration:
                st.state = _H_DONE
                st.end_gap = st.gap_acc
                self.n_done += 1
                stopped = True
            self.steps += n_send
            if k:
                row0 = len(kind_l)
                self.queries += k
                cons.extend(zip(repeat(code, k), repeat(f, k), repeat(s, k),
                                repeat(mid, k), range(row0, row0 + k),
                                repeat(False, k)))
                kind_l.extend([row_code] * k)
                fifo_l.extend([f] * k)
                gap_l.extend([p] * k)
                seq_l.extend([s] * k)
                times_l.extend(range(t + p, t + k * p + 1, p))
            if stopped:
                if k:
                    self.bursts += 1
                    self.bulk_queries += k
                    st.p_row = len(kind_l) - 1
                return True
        if k:
            self.bursts += 1
            self.bulk_queries += k
            st.p_row = len(kind_l) - 1
        if self.steps > self.max_steps:
            raise RuntimeError(
                f"step budget exceeded ({self.max_steps}); possible "
                f"livelock — neither OmniSim nor co-sim detects livelock")
        return False

    def _pattern_horizon(self, st: _HMod) -> int:
        """Number of full periods of ``st.pat`` whose verdicts are all
        derivable from the committed time tables right now.

        Generalizes :meth:`_poll_horizon` to multi-site patterns and
        success steps.  Step ``j`` of period ``m`` prices at
        ``t0 + m*p + offs[j]`` and accesses per-FIFO seq
        ``b + m*d + pre[j]`` (``d`` = successes per period at that
        (fifo, side), ``pre[j]`` = successes at it earlier in the period),
        so each step's verdict window is a closed form (constant-seq
        failures against one immutable commit time) or one vectorized
        compare against the ``fw_times``/``fr_times`` arrays.  The burst
        horizon is the min over steps — conservative by construction:
        only pre-burst table entries are consulted, and committed times
        are immutable, so every admitted verdict is exact.
        """
        pat = st.pat
        P = len(pat)
        offs = []
        acc = 0
        for (_c, _f, g, _o) in pat:
            acc += g
            offs.append(acc)
        p = acc
        if p <= 0:
            return 0
        t0 = st.times[-1]
        d_map: Dict[Tuple[int, int], int] = {}
        pre = []
        for (c, f, _g, o) in pat:
            key = (f, c & 1)
            pre.append(d_map.get(key, 0))
            if o:
                d_map[key] = d_map.get(key, 0) + 1
        M = 1 << 16                  # caps the vectorized window per burst
        for j, (c, f, _g, o) in enumerate(pat):
            d = d_map.get((f, c & 1), 0)
            off = offs[j]
            if c == _QC_READ_NB:
                b = self.rseq[f] + 1 + pre[j]
                wt = self.fw_times[f]
                if o:
                    if d <= 0:
                        return 0
                    avail = (wt.n - b) // d + 1 if wt.n >= b else 0
                    cap = min(M, avail)
                    if cap <= 0:
                        return 0
                    m = np.arange(cap, dtype=np.int64)
                    ok = wt.a[b + m * d - 1] < t0 + m * p + off
                    c_j = cap if ok.all() else int(np.argmin(ok))
                elif d == 0:
                    if b > wt.n:
                        return 0     # undecidable: forced rule must handle
                    c_j = (int(wt.a[b - 1]) - t0 - off) // p + 1
                else:
                    avail = (wt.n - b) // d + 1 if wt.n >= b else 0
                    cap = min(M, avail)
                    if cap <= 0:
                        return 0
                    m = np.arange(cap, dtype=np.int64)
                    ok = wt.a[b + m * d - 1] >= t0 + m * p + off
                    c_j = cap if ok.all() else int(np.argmin(ok))
            else:                                   # _QC_WRITE_NB
                b = self.wseq[f] + 1 + pre[j]
                dep = self.depths[f]
                rt = self.fr_times[f]
                if o:
                    if d <= 0:
                        return 0
                    # tg(m) = b + m*d - dep: True while tg <= 0, then needs
                    # the committed WAR-target read time to precede t(m)
                    m0 = (dep - b) // d + 1 if dep >= b else 0
                    avail = ((rt.n + dep - b) // d + 1
                             if rt.n + dep >= b else 0)
                    cap = min(M, avail)
                    if cap <= 0:
                        return 0
                    if cap <= m0:
                        c_j = cap
                    else:
                        m = np.arange(m0, cap, dtype=np.int64)
                        tg = b + m * d - dep
                        ok = rt.a[tg - 1] < t0 + m * p + off
                        c_j = m0 + (len(m) if ok.all()
                                    else int(np.argmin(ok)))
                elif d == 0:
                    tg = b - dep
                    if tg <= 0 or tg > rt.n:
                        return 0
                    c_j = (int(rt.a[tg - 1]) - t0 - off) // p + 1
                else:
                    if b - dep <= 0:
                        return 0     # next verdict is True, not the fail
                    avail = ((rt.n + dep - b) // d + 1
                             if rt.n + dep >= b else 0)
                    cap = min(M, avail)
                    if cap <= 0:
                        return 0
                    m = np.arange(cap, dtype=np.int64)
                    tg = b + m * d - dep
                    ok = rt.a[tg - 1] >= t0 + m * p + off
                    c_j = cap if ok.all() else int(np.argmin(ok))
            if c_j < M:
                M = c_j
                if M <= 0:
                    return 0
        return M

    def _burst_pattern(self, st: _HMod) -> bool:
        """Resolve full periods of the armed pattern in one burst.

        The multi-site / success-stream counterpart of
        :meth:`_burst_polls`: the horizon fixes every step's verdict in
        advance, and the module's stream is advanced through a per-step
        verification loop that admits only the recorded pattern — same
        query class, site and gap, timing-only body ops absorbed.  Success
        steps commit for real as they verify (buffer pops/pushes, seq
        bumps, ``fw``/``fr`` appends at the closed-form step times), so a
        divergence stops the burst *before* the off-pattern yield commits
        and results stay bit-identical.  Returns True when the module
        terminated during the burst.
        """
        if st.pending_op is not None:
            return False
        pat = st.pat
        P = len(pat)
        M = self._pattern_horizon(st)
        if M <= 0:
            return False
        K = M * P
        buffers = self.buffers
        rseq, wseq = self.rseq, self.wseq
        fw, fr = self.fw_times, self.fr_times
        cons = self.constraints
        kind_l, fifo_l, gap_l = st.kind, st.fifo, st.gap
        seq_l, times_l = st.seq, st.times
        mid = st.mid
        t = times_l[-1]
        touched_r: set = set()
        touched_w: set = set()
        k = 0
        stopped = False
        if st.cand is not None:
            # cached-branch arm: verify ylog entries against the pattern
            # and the live buffers; any mismatch (including a value
            # mismatch on a success) stops the burst and hands the entry
            # to the normal cached dispatch, which re-verifies and
            # diverges properly
            ylog = st.cand.ylog
            L = len(ylog)
            pos = st.pos
            probes_total = 0
            n_ent = 0
            while k < K:
                g_extra, probes, npos = 0, 0, pos
                while npos < L:
                    e = ylog[npos]
                    c0 = e[0]
                    if c0 == OP_DELAY:
                        g_extra += e[2]
                    elif c0 == OP_PROBE_DEAD:
                        g_extra += 1
                        probes += 1
                    else:
                        break
                    npos += 1
                if npos >= L:
                    break
                code_j, f_j, g_j, out_j = pat[k % P]
                op_code = OP_READ_NB if code_j == _QC_READ_NB else OP_WRITE_NB
                e = ylog[npos]
                if (e[0] != op_code or e[1] != f_j
                        or st.gap_acc + g_extra != g_j):
                    break
                pay = e[2]
                if type(pay) is not tuple or pay[0] is not out_j:
                    break
                if code_j == _QC_READ_NB:
                    s = rseq[f_j] + 1
                    if out_j:
                        buf = buffers[f_j]
                        if not buf or buf[0] != pay[1]:
                            break             # value divergence: fall back
                        v = buf.popleft()
                        rseq[f_j] = s
                        fr[f_j].append(t + g_j)
                        touched_r.add(f_j)
                        kind_l.append(OP_READ_NB)
                        st.send = (True, v)
                    else:
                        kind_l.append(OP_NB_FAIL)
                        st.send = (False, None)
                else:
                    s = wseq[f_j] + 1
                    if out_j:
                        wseq[f_j] = s
                        fw[f_j].append(t + g_j)
                        touched_w.add(f_j)
                        buffers[f_j].append(pay[1])
                        kind_l.append(OP_WRITE_NB)
                        st.send = True
                    else:
                        kind_l.append(OP_NB_FAIL)
                        st.send = False
                t += g_j
                st.gap_acc = 1
                cons.append((code_j, f_j, s, mid, len(times_l), out_j))
                fifo_l.append(f_j)
                gap_l.append(g_j)
                seq_l.append(s)
                times_l.append(t)
                probes_total += probes
                n_ent += npos + 1 - pos
                pos = npos + 1
                k += 1
            self.steps += n_ent
            self.skipped_probes += probes_total
            st.pos = pos
            diverged = k < K
        else:
            # live-generator arm
            gen = st.gen
            gen_send = gen.send
            log = st.ylog is not None
            send = st.send
            budget = self.max_steps - self.steps
            n_send = 0
            try:
                while k < K:
                    op = gen_send(send)
                    n_send += 1
                    if n_send > budget:
                        raise RuntimeError(
                            f"step budget exceeded ({self.max_steps}); "
                            f"possible livelock — neither OmniSim nor "
                            f"co-sim detects livelock")
                    send = None
                    cls = op.__class__
                    while True:    # timing-only body ops keep the pattern
                        if cls is Delay:
                            st.gap_acc += op.cycles
                            if log:
                                st.ylog.append((OP_DELAY, -1, op.cycles))
                                st.sends.append(None)
                        elif cls is Emit:
                            self.outputs[op.key] = op.value
                            if log:
                                st.ylog.append((OP_EMIT, -1,
                                                (op.key, op.value)))
                                st.sends.append(None)
                        elif (cls is Empty or cls is Full) and not op.used:
                            self.skipped_probes += 1
                            st.gap_acc += 1
                            if log:
                                st.ylog.append((OP_PROBE_DEAD, op.fifo.fid,
                                                None))
                                st.sends.append(None)
                        else:
                            break
                        op = gen_send(None)
                        n_send += 1
                        if n_send > budget:
                            raise RuntimeError(
                                f"step budget exceeded ({self.max_steps}); "
                                f"possible livelock — neither OmniSim nor "
                                f"co-sim detects livelock")
                        cls = op.__class__
                    code_j, f_j, g_j, out_j = pat[k % P]
                    qcls = ReadNB if code_j == _QC_READ_NB else WriteNB
                    if (cls is not qcls or op.fifo.fid != f_j
                            or st.gap_acc != g_j):
                        st.pending_op = op
                        break
                    t += g_j
                    st.gap_acc = 1
                    if code_j == _QC_READ_NB:
                        s = rseq[f_j] + 1
                        if out_j:
                            v = buffers[f_j].popleft()
                            rseq[f_j] = s
                            fr[f_j].append(t)
                            touched_r.add(f_j)
                            kind_l.append(OP_READ_NB)
                            send = (True, v)
                        else:
                            kind_l.append(OP_NB_FAIL)
                            send = (False, None)
                        if log:
                            st.ylog.append((OP_READ_NB, f_j, send))
                            st.sends.append(send)
                    else:
                        s = wseq[f_j] + 1
                        pay = op.value
                        if out_j:
                            wseq[f_j] = s
                            fw[f_j].append(t)
                            touched_w.add(f_j)
                            buffers[f_j].append(pay)
                            kind_l.append(OP_WRITE_NB)
                            send = True
                        else:
                            kind_l.append(OP_NB_FAIL)
                            send = False
                        if log:
                            st.ylog.append((OP_WRITE_NB, f_j, (out_j, pay)))
                            st.sends.append(send)
                    cons.append((code_j, f_j, s, mid, len(times_l), out_j))
                    fifo_l.append(f_j)
                    gap_l.append(g_j)
                    seq_l.append(s)
                    times_l.append(t)
                    k += 1
                else:
                    st.send = send
                if st.pending_op is not None:
                    st.send = None
            except StopIteration:
                st.state = _H_DONE
                st.end_gap = st.gap_acc
                self.n_done += 1
                stopped = True
            self.steps += n_send
            diverged = st.pending_op is not None
        # table growth during the burst wakes exactly like the frontier
        for f_j in touched_r:
            self._mark_dirty(self.writer_of.get(f_j, -1))
            w = self.qwatch_r[f_j]
            if w >= 0:
                self.rp_wake.add(w)
        for f_j in touched_w:
            self._mark_dirty(self.reader_of.get(f_j, -1))
            w = self.qwatch_w[f_j]
            if w >= 0:
                self.rp_wake.add(w)
            wr = self.waiting_reader.pop(f_j, None)
            if wr is not None:
                self._enqueue(wr)
        if k:
            self.queries += k
            self.bursts += 1
            self.bulk_queries += k
            st.p_row = len(kind_l) - 1
        if diverged and not stopped:
            st.pat = None
            st.p_hist.clear()
            st.streak = 0
        if self.steps > self.max_steps:
            raise RuntimeError(
                f"step budget exceeded ({self.max_steps}); possible "
                f"livelock — neither OmniSim nor co-sim detects livelock")
        return stopped

    def _force_earliest(self) -> None:
        """Earliest-query forced-false rule (paper Sec. 7.1).

        Sound under run-ahead recording: at a stuck state every recorded-
        but-untimed event transitively waits (through chain and RAW/WAR
        sources) on some pending query's module resuming, resumptions occur
        at cycles > the earliest priced query's cycle, and any *unpriced*
        query's own cycle depends on such an event — so no future commit can
        land strictly before the forced query's cycle.
        """
        while self.heap:
            t, qid, mid = heapq.heappop(self.heap)
            st = self.mods[mid]
            if st.state != _H_PARK_QUERY or st.qid != qid:
                continue
            self.forced += 1
            self._apply_query(st, False)
            self._enqueue(mid)
            return
        raise AssertionError("_force_earliest called with no priced query")

    def _resolve_parked(self) -> bool:
        """At quiescence: price newly-solvable queries, then resolve every
        currently-definitive one earliest-first (engine step ❹).

        Gated on the watch slots: a parked verdict can only flip from
        undecidable when its target table grows, every commit site wakes
        the (unique, by SPSC) watcher of the grown (fifo, side), and
        unpriced queries can only price after their own chain advanced —
        so a phase in which no watched table grew and nothing is unpriced
        is two set checks, not a heap scan.  That is the common case on
        forced-false-heavy designs, where each phase forces exactly one
        query.  Past the gate, resolution drains the heap scalar-wise
        below :data:`_PARK_VEC_MIN` parked queries and through the
        vectorized numpy pricer above it.
        """
        if self.unpriced:
            for mid in sorted(self.unpriced):
                st = self.mods[mid]
                if st.state != _H_PARK_QUERY:
                    self.unpriced.discard(mid)
                    continue
                if len(st.times) == len(st.kind):
                    t = (st.times[-1] if st.times else 0) + st.gap_acc
                    st.q_time = t
                    self.unpriced.discard(mid)
                    heapq.heappush(self.heap, (t, st.qid, mid))
                    self.rp_wake.add(mid)   # first verdict check is here
        if not self.rp_wake:
            return False
        self.rp_wake.clear()
        heap = self.heap
        if not heap:
            return False
        if len(heap) >= _PARK_VEC_MIN:
            return self._resolve_parked_np()
        mods = self.mods
        resolved = False
        remaining: List[Tuple[int, int, int]] = []
        while heap:
            entry = heapq.heappop(heap)
            t, qid, mid = entry
            st = mods[mid]
            if st.state != _H_PARK_QUERY or st.qid != qid:
                continue
            v = self._verdict(st.q_code, st.q_fifo, st.q_seq, t)
            if v is None:
                remaining.append(entry)
                continue
            self._apply_query(st, v)
            self._enqueue(mid)
            resolved = True
        self.heap = remaining        # drained in heap order -> still a heap
        return resolved

    def _resolve_parked_np(self) -> bool:
        """Vectorized parked-query resolution for wide designs.

        One pass builds flat arrays of every live parked query and prices
        all verdicts against the ``fw_times``/``fr_times`` numpy tables at
        once (per-unique-FIFO gathers), instead of a heappop + per-query
        ``_verdict`` round trip per entry — the ``_solve_batch`` move
        applied to engine step ❹.  Verdicts decided against the pre-pass
        tables are identical to the sequential drain's (committed times
        are immutable, so a decided verdict can never change); queries
        that only become decidable from commits made *during* this pass
        resolve on the next quiescence round with the same outcome.
        """
        heap = self.heap
        mods = self.mods
        n = len(heap)
        t_a = np.zeros(n, dtype=np.int64)
        qid_a = np.zeros(n, dtype=np.int64)
        code_a = np.zeros(n, dtype=np.int64)
        fifo_a = np.zeros(n, dtype=np.int64)
        seq_a = np.zeros(n, dtype=np.int64)
        live = np.zeros(n, dtype=bool)
        for i, (t, qid, mid) in enumerate(heap):
            st = mods[mid]
            if st.state != _H_PARK_QUERY or st.qid != qid:
                continue
            live[i] = True
            t_a[i] = t
            qid_a[i] = qid
            code_a[i] = st.q_code
            fifo_a[i] = st.q_fifo
            seq_a[i] = st.q_seq
        if not live.any():
            self.heap = []
            return False
        n_fifo = len(self.depths)
        fwn = np.fromiter((b.n for b in self.fw_times), np.int64, n_fifo)
        frn = np.fromiter((b.n for b in self.fr_times), np.int64, n_fifo)
        dep = np.asarray(self.depths, dtype=np.int64)
        rs = (code_a % 2) == 0        # _QC_READ_NB / _QC_EMPTY are read-side
        out = np.zeros(n, dtype=bool)
        m_r = live & rs & (seq_a <= fwn[fifo_a])
        for f in np.unique(fifo_a[m_r]):
            mm = m_r & (fifo_a == f)
            out[mm] = self.fw_times[f].a[seq_a[mm] - 1] < t_a[mm]
        tg = seq_a - dep[fifo_a]
        m_w0 = live & ~rs & (tg <= 0)
        out[m_w0] = True
        m_w = live & ~rs & (tg > 0) & (tg <= frn[fifo_a])
        for f in np.unique(fifo_a[m_w]):
            mm = m_w & (fifo_a == f)
            out[mm] = self.fr_times[f].a[tg[mm] - 1] < t_a[mm]
        dec = m_r | m_w0 | m_w
        idx = np.flatnonzero(dec)
        if not len(idx):
            return False              # heap untouched: every live entry kept
        order = idx[np.lexsort((qid_a[idx], t_a[idx]))]
        for i in order:
            mid = heap[i][2]
            self._apply_query(mods[mid], bool(out[i]))
            self._enqueue(mid)
        kept = [heap[i] for i in np.flatnonzero(live & ~dec)]
        heapq.heapify(kept)
        self.heap = kept
        return True

    # -------------------------------------------------------- cache plumbing
    # Invariants: while ``st.cand`` is set, the module's processed yield
    # history IS ``st.cand.ylog[:st.pos]`` (every value/outcome-carrying
    # entry is validated against live state before being applied), so
    # ``st.ylog``/``st.sends`` are not maintained; they are reconstructed
    # from the candidate prefix on divergence.  Live modules with a cache
    # attached log every yield.

    @staticmethod
    def _log(st: _HMod, code: int, f: int, payload) -> None:
        st.ylog.append((code, f, payload))

    @staticmethod
    def _ff_match(cls, code: int) -> bool:
        """Loose yield-vs-log check during generator fast-forward."""
        if code == OP_PROBE_DEAD:
            return cls is Empty or cls is Full
        return _CLS_TO_OP.get(cls) == code

    def _diverge(self, st: _HMod, expected_entry: tuple, send) -> None:
        """Cached branch diverged from live state: switch to a cached branch
        that re-converges with the live outcome if one exists, else
        materialize the generator (fast-forwarded with the already-delivered
        send values, which equal the validated candidate prefix)."""
        pos = st.pos
        prefix = st.cand.ylog[:pos]
        for alt in st.cand_alts:
            if alt is st.cand or len(alt.ylog) <= pos:
                continue
            if alt.ylog[pos] == expected_entry and alt.ylog[:pos] == prefix:
                self.cache.switches += 1
                st.cand = alt
                st.pos += 1
                return
        self.cache.divergences += 1
        sends = st.cand.sends[:pos]
        st.cand = None
        st.ylog = prefix + [expected_entry]
        st.sends = sends + [send]
        gen = self.program.modules[st.mid].fn()
        try:
            op = next(gen)
            for i in range(pos):
                if not self._ff_match(op.__class__, prefix[i][0]):
                    raise self._unsup(
                        f"module '{st.name}' is not re-runnable (yield "
                        f"stream diverged on replay); bodies must be pure")
                op = gen.send(sends[i])
        except StopIteration:
            raise self._unsup(
                f"module '{st.name}' is not re-runnable (terminated early "
                f"on replay); bodies must be pure")
        if not self._ff_match(op.__class__, expected_entry[0]):
            raise self._unsup(
                f"module '{st.name}' is not re-runnable (yield stream "
                f"diverged on replay); bodies must be pure")
        st.gen = gen
        st.started = True

    def _replay_cached_bulk(self, st: _HMod) -> bool:
        """Replay a window of validated cached rows array-at-a-time.

        Instead of re-dispatching every cached yield through Python, the
        candidate branch's compiled :class:`_RunArrays` view identifies the
        run of committing blocking rows ahead of ``st.pos`` (bounded by the
        next query), validates the whole window with one per-FIFO check —
        expected read values against the current buffer contents, sequence
        alignment against the live counters — and commits rows, buffers,
        emits and probe counts in bulk.  Windows stop conservatively at the
        first read not satisfiable from the *current* buffers (a later
        per-yield step parks or diverges there, exactly as before), so the
        fast path changes only the dispatch granularity, never an outcome.
        """
        cand = st.cand
        arr = cand.arr
        if arr is None:
            arr = cand.arr = _RunArrays(cand.ylog)
        pos = st.pos
        if not arr.boundary[pos]:
            return False
        ev_pos = arr.ev_pos
        e0 = int(np.searchsorted(ev_pos, pos))
        if e0 >= len(ev_pos) or arr.ev_rowidx[e0] < 0:
            return False
        r0 = int(arr.ev_rowidx[e0])
        r1 = r0 + int(arr.next_q[e0]) - e0
        if r1 - r0 < _CACHE_BULK_MIN:
            return False
        # cap the window at the first read not satisfiable (count or value)
        # from the current buffer contents; verify replay seq alignment
        r_stop = r1
        for f in arr.read_fifos:
            rr = arr.rrow_of[f]
            o0 = int(np.searchsorted(rr, r0))
            o1 = int(np.searchsorted(rr, r_stop))
            if o1 == o0:
                continue
            if self.rseq[f] != o0:       # misaligned: per-yield path decides
                return False
            vals = arr.rvals_of[f]
            k, need = 0, o1 - o0
            for v in self.buffers[f]:
                if vals[o0 + k] != v:
                    break
                k += 1
                if k == need:
                    break
            if k < need:
                r_stop = int(rr[o0 + k])
        if r_stop <= r0:
            return False
        for f in arr.write_fifos:
            wr = arr.wrow_of[f]
            o0 = int(np.searchsorted(wr, r0))
            if int(np.searchsorted(wr, r_stop)) > o0 and self.wseq[f] != o0:
                return False
        # ---- commit the validated window
        gap0 = st.gap_acc
        st.kind.extend(arr.row_code[r0:r_stop])
        st.fifo.extend(arr.row_fifo[r0:r_stop])
        gaps = arr.row_gap[r0:r_stop]
        if gap0 != 1:
            gaps = [gap0 + gaps[0] - 1] + gaps[1:]
        st.gap.extend(gaps)
        st.seq.extend(arr.row_seq[r0:r_stop])
        mid = st.mid
        for f in arr.read_fifos:
            rr = arr.rrow_of[f]
            o0 = int(np.searchsorted(rr, r0))
            o1 = int(np.searchsorted(rr, r_stop))
            if o1 == o0:
                continue
            self._check_endpoint(f, mid, False)
            buf = self.buffers[f]
            for _ in range(o1 - o0):
                buf.popleft()
            self.rseq[f] = o1
        for f in arr.write_fifos:
            wr = arr.wrow_of[f]
            o0 = int(np.searchsorted(wr, r0))
            o1 = int(np.searchsorted(wr, r_stop))
            if o1 == o0:
                continue
            self._check_endpoint(f, mid, True)
            self.buffers[f].extend(arr.wvals_of[f][o0:o1])
            self.wseq[f] = o1
            w = self.waiting_reader.pop(f, None)
            if w is not None:
                self._enqueue(w)
        p_end = int(arr.row_pos[r_stop - 1]) + 1
        if len(arr.emit_pos):
            a = int(np.searchsorted(arr.emit_pos, pos))
            b = int(np.searchsorted(arr.emit_pos, p_end))
            for i in range(a, b):
                kv = arr.emit_kv[i]
                self.outputs[kv[0]] = kv[1]
        self.skipped_probes += int(arr.row_probes_cum[r_stop]
                                   - arr.row_probes_cum[r0])
        self.steps += p_end - pos
        self.cache_bulk_rows += r_stop - r0
        st.pos = p_end
        st.gap_acc = 1
        return True

    # ------------------------------------------------------------- recording
    def _issue_query(self, st: _HMod, code: int, f: int, payload) -> bool:
        """Handle a query op; True if resolved inline (task may continue)."""
        self.queries += 1
        read_side = _QC_IS_READ_SIDE[code]
        self._check_endpoint(f, st.mid, not read_side)
        s = (self.rseq[f] if read_side else self.wseq[f]) + 1
        st.q_code, st.q_fifo, st.q_seq, st.q_payload = code, f, s, payload
        if len(st.times) != len(st.kind):
            # chain not timed up to the query: try to close the gap now.
            # When no other module has pending rows and nothing is dirty,
            # this module's own frontier is the entire fixpoint (its
            # sources are all committed or unrecorded) — skip the solver
            # wrapper and batch gate
            if not self.pending and not self.solve_dirty:
                self._advance_frontier(st)
                if len(st.times) != len(st.kind):
                    self.pending.add(st.mid)
                    self._solve()
            else:
                self.pending.add(st.mid)
                self._solve()
        if len(st.times) == len(st.kind):
            t = (st.times[-1] if st.times else 0) + st.gap_acc
            st.q_time = t
            # inlined _verdict (hot path: most queries price right here)
            if read_side:
                wt = self.fw_times[f]
                if s <= wt.n:
                    self._apply_query(st, bool(wt.a[s - 1] < t))
                    return True
            else:
                tg = s - self.depths[f]
                if tg <= 0:
                    self._apply_query(st, True)
                    return True
                rt = self.fr_times[f]
                if tg <= rt.n:
                    self._apply_query(st, bool(rt.a[tg - 1] < t))
                    return True
            self._qid += 1
            st.qid = self._qid
            st.state = _H_PARK_QUERY
            if read_side:
                self.qwatch_w[f] = st.mid
            else:
                self.qwatch_r[f] = st.mid
            heapq.heappush(self.heap, (t, st.qid, st.mid))
            return False
        self._qid += 1
        st.qid = self._qid
        st.state = _H_PARK_QUERY
        if read_side:
            self.qwatch_w[f] = st.mid
        else:
            self.qwatch_r[f] = st.mid
        self.unpriced.add(st.mid)
        return False

    def _advance(self, mid: int) -> None:
        """Drive one module until it parks, finishes, or the run queue must
        rotate — the hybrid recorder's hot loop (cheap list appends instead
        of the generator engine's per-op graph-object churn; endpoint checks
        and row recording are inlined, the step budget lives in a local that
        is flushed around the bulk helpers)."""
        st = self.mods[mid]
        state = st.state
        if state == _H_DONE or state == _H_PARK_QUERY:
            return
        self.activations += 1
        buffers = self.buffers
        rseq, wseq = self.rseq, self.wseq
        waiting_reader = self.waiting_reader
        reader_of, writer_of = self.reader_of, self.writer_of
        kapp, fapp = st.kind.append, st.fifo.append
        gapp, sapp = st.gap.append, st.seq.append
        if state == _H_PARK_READ:
            f = st.park_fid
            buf = buffers[f]
            if not buf:
                raise self._unsup(
                    f"fifo {f} drained by another reader while "
                    f"'{st.name}' was parked — SPSC violation; deferring to "
                    f"the generator engine's endpoint check")
            v = buf.popleft()
            if st.cand is not None:
                if st.cand.ylog[st.pos][2] != v:
                    self._diverge(st, (OP_READ, f, v), v)
                else:
                    st.pos += 1
            elif st.ylog is not None:
                st.ylog[-1] = (OP_READ, f, v)     # patch the parked entry
                st.sends.append(v)
            s = rseq[f] = rseq[f] + 1
            kapp(OP_READ)
            fapp(f)
            gapp(st.gap_acc)
            sapp(s)
            st.gap_acc = 1
            st.send = v
            st.park_fid = -1
            st.state = _H_READY
            if len(st.kind) - len(st.times) == 1:
                self._eager_read(st, f, s)
        steps = self.steps
        max_steps = self.max_steps
        try:
            while True:
                # ---- periodized poll loop: burst-resolve K outcomes at once
                if st.burst:
                    st.burst = False
                    self.steps = steps
                    if st.pat is not None:
                        if self._burst_pattern(st):
                            return
                    else:
                        K = self._poll_horizon(st)
                        if K > 0 and self._burst_polls(st, K):
                            return
                    steps = self.steps
                # ---- fetch the next yielded op (cached stream or generator)
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"step budget exceeded ({max_steps}); possible "
                        f"livelock — neither OmniSim nor co-sim detects "
                        f"livelock")
                cand = st.cand
                if cand is not None:
                    if st.pos >= len(cand.ylog):
                        st.state = _H_DONE
                        st.end_gap = st.gap_acc
                        self.n_done += 1
                        if self.cache is not None:
                            self.cache.hits += 1
                            self.cache.promote(self.sig, mid, cand)
                        return
                    self.steps = steps
                    if self._replay_cached_bulk(st):
                        steps = self.steps
                        continue
                    code, f, payload = cand.ylog[st.pos]
                    # dispatch on the cached opcode
                    if code == OP_READ:
                        if reader_of.setdefault(f, mid) != mid:
                            raise self._unsup(
                                f"fifo {f} has two reader modules — SPSC "
                                f"violation; deferring to the generator "
                                f"engine's endpoint check")
                        buf = buffers[f]
                        if not buf:
                            prev = waiting_reader.get(f)
                            if prev is not None and prev != mid:
                                raise self._unsup(
                                    f"two modules read fifo {f} — SPSC "
                                    f"violation; deferring to the generator "
                                    f"engine's endpoint check")
                            waiting_reader[f] = mid
                            st.park_fid = f
                            st.state = _H_PARK_READ
                            return
                        v = buf.popleft()
                        if payload != v:
                            self._diverge(st, (OP_READ, f, v), v)
                        else:
                            st.pos += 1
                        s = rseq[f] = rseq[f] + 1
                        kapp(OP_READ)
                        fapp(f)
                        gapp(st.gap_acc)
                        sapp(s)
                        st.gap_acc = 1
                        st.send = v
                        if len(st.kind) - len(st.times) == 1:
                            self._eager_read(st, f, s)
                    elif code == OP_WRITE:
                        if writer_of.setdefault(f, mid) != mid:
                            raise self._unsup(
                                f"fifo {f} has two writer modules — SPSC "
                                f"violation; deferring to the generator "
                                f"engine's endpoint check")
                        st.pos += 1
                        s = wseq[f] = wseq[f] + 1
                        kapp(OP_WRITE)
                        fapp(f)
                        gapp(st.gap_acc)
                        sapp(s)
                        st.gap_acc = 1
                        if len(st.kind) - len(st.times) == 1:
                            self._eager_write(st, f, s)
                        buffers[f].append(payload)
                        if waiting_reader:
                            w = waiting_reader.pop(f, None)
                            if w is not None:
                                self._enqueue(w)
                        st.send = None
                    elif code == OP_DELAY:
                        st.pos += 1
                        st.gap_acc += payload
                        st.send = None
                    elif code == OP_EMIT:
                        st.pos += 1
                        self.outputs[payload[0]] = payload[1]
                        st.send = None
                    elif code == OP_PROBE_DEAD:
                        st.pos += 1
                        self.skipped_probes += 1
                        st.gap_acc += 1
                        st.send = None
                    else:   # query op: OP_READ_NB / OP_WRITE_NB / OP_EMPTY/FULL
                        qc = _OP_TO_QC[code]
                        qpayload = payload[1] if code == OP_WRITE_NB else None
                        if not self._issue_query(st, qc, f, qpayload):
                            return
                    continue
                # ---- live generator path
                log = st.ylog is not None
                op = st.pending_op
                if op is not None:      # yield left over from a burst break
                    st.pending_op = None
                else:
                    gen = st.gen
                    if gen is None:
                        gen = st.gen = self.program.modules[mid].fn()
                    try:
                        if not st.started:
                            st.started = True
                            op = next(gen)
                        else:
                            op = gen.send(st.send)
                    except StopIteration:
                        st.state = _H_DONE
                        st.end_gap = st.gap_acc
                        self.n_done += 1
                        return
                st.send = None
                cls = op.__class__
                if cls is Read:
                    f = op.fifo.fid
                    if reader_of.setdefault(f, mid) != mid:
                        raise self._unsup(
                            f"fifo {f} has two reader modules — SPSC "
                            f"violation; deferring to the generator engine's "
                            f"endpoint check")
                    buf = buffers[f]
                    if not buf:
                        prev = waiting_reader.get(f)
                        if prev is not None and prev != mid:
                            raise self._unsup(
                                f"two modules read fifo '{op.fifo.name}' — "
                                f"SPSC violation; deferring to the generator "
                                f"engine's endpoint check")
                        waiting_reader[f] = mid
                        st.park_fid = f
                        st.state = _H_PARK_READ
                        if log:
                            self._log(st, OP_READ, f, None)  # patched on wake
                        return
                    v = buf.popleft()
                    s = rseq[f] = rseq[f] + 1
                    kapp(OP_READ)
                    fapp(f)
                    gapp(st.gap_acc)
                    sapp(s)
                    st.gap_acc = 1
                    st.send = v
                    if len(st.kind) - len(st.times) == 1:
                        self._eager_read(st, f, s)
                    if log:
                        self._log(st, OP_READ, f, v)
                        st.sends.append(v)
                elif cls is Write:
                    f = op.fifo.fid
                    if writer_of.setdefault(f, mid) != mid:
                        raise self._unsup(
                            f"fifo {f} has two writer modules — SPSC "
                            f"violation; deferring to the generator engine's "
                            f"endpoint check")
                    s = wseq[f] = wseq[f] + 1
                    kapp(OP_WRITE)
                    fapp(f)
                    gapp(st.gap_acc)
                    sapp(s)
                    st.gap_acc = 1
                    if len(st.kind) - len(st.times) == 1:
                        self._eager_write(st, f, s)
                    buffers[f].append(op.value)
                    if waiting_reader:
                        w = waiting_reader.pop(f, None)
                        if w is not None:
                            self._enqueue(w)
                    if log:
                        self._log(st, OP_WRITE, f, op.value)
                        st.sends.append(None)
                elif cls is Delay:
                    st.gap_acc += op.cycles
                    if log:
                        self._log(st, OP_DELAY, -1, op.cycles)
                        st.sends.append(None)
                elif cls is Emit:
                    self.outputs[op.key] = op.value
                    if log:
                        self._log(st, OP_EMIT, -1, (op.key, op.value))
                        st.sends.append(None)
                elif (cls is Empty or cls is Full) and not op.used:
                    self.skipped_probes += 1
                    st.gap_acc += 1
                    if log:
                        self._log(st, OP_PROBE_DEAD, op.fifo.fid, None)
                        st.sends.append(None)
                elif cls in (ReadNB, WriteNB, Empty, Full):
                    if not self._issue_query(st, _CLS_TO_QC[cls],
                                             op.fifo.fid,
                                             getattr(op, "value", None)):
                        return
                else:
                    raise TypeError(f"unknown op {op!r}")
        finally:
            self.steps = steps

    # ------------------------------------------------ whole-run cached replay
    def _replay_full(self, full: _FullRun) -> bool:
        """Bulk-replay a cached complete run with per-entry verification.

        Phase 1 verifies, touching no engine state: every row's committed
        time must equal ``max(t_prev + gap, source + 1)`` against the
        claimed per-FIFO tables (query rows carry no source: their time
        must be chain-exact), and every recorded query outcome must match
        the Table-2 verdict those tables imply.  A completed run's
        dependency graph is acyclic, so pointwise fixpoint equality pins
        the unique solution — any corruption or semantic drift rejects
        the entry.  Phase 2 installs the arrays and counters; the caller
        then finishes through the ordinary :meth:`_finish`.
        """
        mods = self.mods
        n_mod = len(mods)
        depths = self.depths
        n_fifo = len(depths)
        kinds, fifos, gaps = full.kind, full.fifo, full.gap
        seqs, times = full.seq, full.times
        # ---- claimed per-FIFO tables (SPSC: row order == seq order)
        fw_tab: List[Optional[np.ndarray]] = [None] * n_fifo
        fr_tab: List[Optional[np.ndarray]] = [None] * n_fifo
        for f, mid in full.writer_of.items():
            k = kinds[mid]
            m = ((k == OP_WRITE) | (k == OP_WRITE_NB)) & (fifos[mid] == f)
            fw_tab[f] = times[mid][m]
        for f, mid in full.reader_of.items():
            k = kinds[mid]
            m = ((k == OP_READ) | (k == OP_READ_NB)) & (fifos[mid] == f)
            fr_tab[f] = times[mid][m]
        # ---- per-row time verification: t == max(chain, source + 1)
        for mid in range(n_mod):
            k = kinds[mid]
            n = len(k)
            if n == 0:
                continue
            fo, g, s, t = fifos[mid], gaps[mid], seqs[mid], times[mid]
            c = np.full(n, NEGI, dtype=np.int64)
            rd = k == OP_READ
            if rd.any():
                for f in np.unique(fo[rd]):
                    m = rd & (fo == f)
                    tab = fw_tab[f]
                    sv = s[m]
                    if tab is None or sv[-1] > len(tab):
                        return False          # blocking read never satisfied
                    c[m] = tab[sv - 1] + 1
            wr = k == OP_WRITE
            if wr.any():
                for f in np.unique(fo[wr]):
                    m = wr & (fo == f)
                    tg = s[m] - depths[f]
                    con = tg > 0
                    if con.any():
                        tab = fr_tab[f]
                        if tab is None or tg[con][-1] > len(tab):
                            return False      # WAR slot never freed
                        idx = np.flatnonzero(m)[con]
                        c[idx] = tab[tg[con] - 1] + 1
            prev = np.empty(n, dtype=np.int64)
            prev[0] = 0
            prev[1:] = t[:-1]
            if not np.array_equal(t, np.maximum(prev + g, c)):
                return False
        # ---- per-query outcome verification against the verified tables
        cons = full.cons
        if len(cons):
            offs = np.zeros(n_mod + 1, dtype=np.int64)
            for mid in range(n_mod):
                offs[mid + 1] = offs[mid] + len(times[mid])
            tglob = (np.concatenate(times) if offs[-1]
                     else np.zeros(0, dtype=np.int64))
            cf, cs = cons[:, 1], cons[:, 2]
            cout = cons[:, 5] != 0
            tq = tglob[offs[cons[:, 3]] + cons[:, 4]]
            rs = (cons[:, 0] % 2) == 0        # read-side query codes
            v = np.zeros(len(cons), dtype=bool)
            for f in np.unique(cf[rs]):
                m = rs & (cf == f)
                tab = fw_tab[f]
                nw = 0 if tab is None else len(tab)
                sv = cs[m]
                ok = sv <= nw
                res = np.zeros(len(sv), dtype=bool)
                if ok.any():
                    res[ok] = tab[sv[ok] - 1] < tq[m][ok]
                v[m] = res
            ws = ~rs
            for f in np.unique(cf[ws]):
                m = ws & (cf == f)
                tab = fr_tab[f]
                nr = 0 if tab is None else len(tab)
                tg = cs[m] - depths[f]
                res = tg <= 0
                dec = ~res & (tg <= nr)
                if dec.any():
                    res[dec] = tab[tg[dec] - 1] < tq[m][dec]
                v[m] = res
            if not np.array_equal(v, cout):
                return False
        # ---- verified: install the run (read-only shared arrays)
        for mid, st in enumerate(mods):
            st.kind = kinds[mid]
            st.fifo = fifos[mid]
            st.gap = gaps[mid]
            st.seq = seqs[mid]
            st.times = times[mid]
            st.end_gap = full.end_gap[mid]
            st.state = _H_DONE
        self.n_done = n_mod
        self.outputs = dict(full.outputs)
        self.buffers = [list(vals) for vals in full.leftover]
        self.reader_of = dict(full.reader_of)
        self.writer_of = dict(full.writer_of)
        self.constraints = cons
        stt = full.stats
        self.queries = stt["queries"]
        self.forced = stt["forced"]
        self.phases = stt["phases"]
        self.activations = stt["activations"]
        self.skipped_probes = stt["skipped_probes"]
        self.bulk_queries = stt["bulk_queries"]
        self.bursts = stt["bursts"]
        self.cache_bulk_rows = full.n_rows
        self._full_replay = True
        self.cache.full_hits += 1
        return True

    # ------------------------------------------------------------------- run
    def run(self) -> SimResult:
        if self.cache is not None and self.periodize:
            full = self.cache.lookup_full(self._fkey)
            if full is not None:
                if self._replay_full(full):
                    return self._finish()
                self.cache.full_rejects += 1
        mods = self.mods
        n_mod = len(mods)
        for st in mods:
            self._enqueue(st.mid)
        runq = self.runq
        pending = self.pending
        while True:
            while runq:
                mid = runq.popleft()
                self.queued[mid] = False
                self._advance(mid)
                st = mods[mid]
                if len(st.kind) != len(st.times):
                    pending.add(mid)
            # ---- quiescence (engine protocol step ❹) ----
            self.phases += 1
            if self.n_done == n_mod:
                break
            if pending or self.solve_dirty:
                self._solve()
            # inline watch-slot gate: _resolve_parked can only make progress
            # when something is unpriced or a watched table grew
            if ((self.unpriced or self.rp_wake)
                    and self._resolve_parked()):
                continue
            if self.heap:
                self._force_earliest()
                continue
            blocked = [st.name for st in mods if st.state != _H_DONE]
            raise self._unsup(
                f"quiescence with no resolvable query — modules {blocked} "
                f"are deadlocked; the generator engine will report the "
                f"exact stall cycle")
        self._solve()
        if any(len(st.times) != len(st.kind) for st in mods):
            raise self._unsup(
                "recorded events cannot all commit under these depths "
                "(structural deadlock or WAR cycle); the generator engine "
                "will report the exact stall cycle")
        return self._finish()

    # --------------------------------------------------------------- finish
    def _finish(self) -> SimResult:
        program = self.program
        mods = self.mods
        n_mod = len(mods)
        n_fifo = len(program.fifos)
        counts = [len(st.kind) for st in mods]
        n = sum(counts) + 2 * n_mod
        seq_w = np.zeros(n, dtype=np.int64)
        node_kind = np.empty(n, dtype=np.int8)
        node_fifo = np.full(n, -1, dtype=np.int64)
        node_seq = np.full(n, -1, dtype=np.int64)
        base = np.full(n, NEGI, dtype=np.int64)
        times = np.zeros(n, dtype=np.int64)
        module_arr = np.empty(n, dtype=np.int64)
        slices: List[Tuple[int, int]] = []
        row_kind_parts, row_fifo_parts, row_node_parts = [], [], []
        row_seq_parts = []
        off = 0
        for m, st in enumerate(mods):
            L = counts[m]
            hi = off + L + 2
            slices.append((off, hi))
            module_arr[off:hi] = m
            node_kind[off] = _NK_START
            base[off] = 0
            times[off] = 0
            rk = np.asarray(st.kind, dtype=np.int64)
            node_kind[off + 1:hi - 1] = _ROW_TO_NK[rk]
            node_fifo[off + 1:hi - 1] = st.fifo
            node_seq[off + 1:hi - 1] = st.seq
            seq_w[off + 1:hi - 1] = st.gap
            seq_w[hi - 1] = st.end_gap
            t_rows = np.asarray(st.times, dtype=np.int64)
            times[off + 1:hi - 1] = t_rows
            times[hi - 1] = (int(t_rows[-1]) if L else 0) + st.end_gap
            node_kind[hi - 1] = _NK_END
            row_kind_parts.append(rk)
            row_fifo_parts.append(np.asarray(st.fifo, dtype=np.int64))
            row_seq_parts.append(np.asarray(st.seq, dtype=np.int64))
            row_node_parts.append(np.arange(off + 1, hi - 1, dtype=np.int64))
            off = hi
        z = np.zeros(0, np.int64)
        kind_all = np.concatenate(row_kind_parts) if row_kind_parts else z
        fifo_all = np.concatenate(row_fifo_parts) if row_fifo_parts else z
        seq_all = np.concatenate(row_seq_parts) if row_seq_parts else z
        node_all = np.concatenate(row_node_parts) if row_node_parts else z
        is_read = (kind_all == OP_READ) | (kind_all == OP_READ_NB)
        is_write = (kind_all == OP_WRITE) | (kind_all == OP_WRITE_NB)
        fifo_w_nodes: List[np.ndarray] = []
        fifo_r_nodes: List[np.ndarray] = []
        fifo_w_blocking: List[np.ndarray] = []
        raw_dst_parts, raw_src_parts = [], []
        war_dst_parts, war_src_parts = [], []
        fifo_wmod = np.full(n_fifo, -1, dtype=np.int64)
        fifo_rmod = np.full(n_fifo, -1, dtype=np.int64)
        for fid in range(n_fifo):
            on_f = fifo_all == fid
            w_sel = on_f & is_write
            r_sel = on_f & is_read
            # committed accesses sorted by per-FIFO seq (commit order; each
            # side is a single module, so chain order == seq order, but the
            # concatenation above is module-major)
            w_order = np.argsort(seq_all[w_sel], kind="stable")
            r_order = np.argsort(seq_all[r_sel], kind="stable")
            w_nodes = node_all[w_sel][w_order]
            r_nodes = node_all[r_sel][r_order]
            fifo_w_nodes.append(np.ascontiguousarray(w_nodes))
            fifo_r_nodes.append(np.ascontiguousarray(r_nodes))
            blocking = np.asarray(kind_all[w_sel][w_order] == OP_WRITE,
                                  dtype=bool)
            fifo_w_blocking.append(blocking)
            fifo_wmod[fid] = self.writer_of.get(fid, -1)
            fifo_rmod[fid] = self.reader_of.get(fid, -1)
            # RAW: r-th blocking read <- r-th write (NB reads: constraint only)
            blk_r = kind_all[r_sel][r_order] == OP_READ
            if blk_r.any():
                raw_dst_parts.append(r_nodes[blk_r])
                raw_src_parts.append(w_nodes[:len(r_nodes)][blk_r])
            # WAR: w-th blocking write (w > S) <- (w-S)-th read
            S = self.depths[fid]
            nw = len(w_nodes)
            if nw > S:
                w_tail = np.arange(S, nw)
                blk_w = blocking[S:]
                sel = w_tail[blk_w]
                if len(sel):
                    war_dst_parts.append(w_nodes[sel])
                    war_src_parts.append(r_nodes[sel - S])
        raw_dst = np.concatenate(raw_dst_parts) if raw_dst_parts else z
        raw_src = np.concatenate(raw_src_parts) if raw_src_parts else z
        war_dst = np.concatenate(war_dst_parts) if war_dst_parts else z
        war_src = np.concatenate(war_src_parts) if war_src_parts else z
        ct = CompiledTrace(n=n, n_modules=n_mod, slices=slices, seq_w=seq_w,
                           base=base, node_kind=node_kind,
                           node_fifo=node_fifo, node_seq=node_seq,
                           fifo_w_nodes=fifo_w_nodes,
                           fifo_r_nodes=fifo_r_nodes, fifo_wmod=fifo_wmod,
                           fifo_rmod=fifo_rmod, raw_dst=raw_dst,
                           raw_src=raw_src, trace=None)
        cycles = int(times.max()) if n else 0

        from .engine import OmniSim
        from .incremental import CompiledGraph
        engine = OmniSim(program)
        engine.outputs = dict(self.outputs)
        engine.graph = TraceSimGraph(ct, times, war_dst, war_src, module_arr)
        for fobj in program.fifos:
            tbl = engine.fifos[fobj.fid]
            w_nodes = fifo_w_nodes[fobj.fid]
            r_nodes = fifo_r_nodes[fobj.fid]
            tbl._w_nodes = w_nodes.astype(np.int64, copy=True)
            tbl._w_times = times[w_nodes]
            tbl._nw = len(w_nodes)
            tbl._r_nodes = r_nodes.astype(np.int64, copy=True)
            tbl._r_times = times[r_nodes]
            tbl._nr = len(r_nodes)
            tbl.values.extend(self.buffers[fobj.fid])
        engine._writer_of = dict(self.writer_of)
        engine._reader_of = dict(self.reader_of)
        # materialize the recorded constraints (engine-identical records):
        # one 2D array carries all columns, so the per-query Python work is a
        # single C-level map/zip instead of five listcomps
        n_cons = len(self.constraints)
        cons_cols = (np.asarray(self.constraints, dtype=np.int64).reshape(
            n_cons, 6) if n_cons else np.zeros((0, 6), np.int64))
        offs_arr = np.asarray([lo for (lo, _) in slices] or [0], np.int64)
        src_col = offs_arr[cons_cols[:, 3]] + 1 + cons_cols[:, 4]

        def _materialize(cons_cols=cons_cols, src_col=src_col):
            return map(Constraint._make, zip(
                map(_QC_TO_RTYPE.__getitem__, cons_cols[:, 0].tolist()),
                cons_cols[:, 1].tolist(), cons_cols[:, 2].tolist(),
                src_col.tolist(), (cons_cols[:, 5] != 0).tolist()))

        constraints = _LazyConstraints(_materialize)
        engine.constraints = constraints
        stats = engine.stats
        stats.nodes = n - n_mod
        stats.edges = engine.graph.n_edges
        stats.queries = self.queries
        stats.queries_forced_false = self.forced
        stats.queries_periodized = self.bulk_queries
        stats.quiescence_rounds = self.phases
        stats.resumes = self.activations
        stats.skipped_probes = self.skipped_probes
        # pre-built incremental cache: resimulate/resimulate_batch skip
        # graph re-interpretation entirely (same contract as the pure
        # trace path, extended with NB constraints + blocking-write masks)
        fifos_cg = [(w.copy(), r.copy(), blk.copy())
                    for w, r, blk in zip(fifo_w_nodes, fifo_r_nodes,
                                         fifo_w_blocking)]
        # read-side query codes are _QC_READ_NB (0) and _QC_EMPTY (2)
        c_kind = (cons_cols[:, 0] % 2).astype(np.int64)
        engine._incr_cache = CompiledGraph(
            n=n,
            raw_dst=raw_dst.copy(),
            raw_src=raw_src.copy(),
            raw_w=np.ones(len(raw_dst), np.int64),
            base=base.copy(),
            chains=[np.arange(lo, hi, dtype=np.int64) for (lo, hi) in slices],
            seq_w=seq_w.copy(),
            fifos=fifos_cg,
            c_kind=c_kind,
            c_fifo=cons_cols[:, 1].copy(),
            c_seq=cons_cols[:, 2].copy(),
            c_src=src_col,
            c_out=cons_cols[:, 5] != 0,
        )
        n_segments = 0
        for rk in row_kind_parts:
            if len(rk):
                blk = rk <= OP_WRITE
                n_segments += int(blk[0]) + int(
                    np.count_nonzero(blk[1:] & ~blk[:-1]))
        engine._hybrid = {
            "ops": int(len(kind_all)),
            "queries": self.queries,
            "forced_false": self.forced,
            "phases": self.phases,
            "segments": n_segments,      # maximal compiled blocking runs
            "bulk_queries": self.bulk_queries,   # periodized poll outcomes
            "bursts": self.bursts,
            "batch_rows": self.batch_rows,       # batch-solver commits
            "batch_solves": self.batch_solves,
            "cache_bulk_rows": self.cache_bulk_rows,
        }
        # commit the memoization caches only on success; a whole-run replay
        # never ran a generator, so its (empty) ylogs must not overwrite the
        # variant cache and its arrays are already stored
        if self.cache is not None and not self._full_replay:
            for st in mods:
                if st.gen is None and st.cand is not None:
                    continue             # full cache replay: nothing new
                self.cache.store(self.sig, st.mid,
                                 _CachedRun(st.ylog, st.sends))
            self.cache.store_full(self._fkey, _FullRun(
                row_kind_parts,
                row_fifo_parts,
                [np.asarray(st.gap, dtype=np.int64) for st in mods],
                row_seq_parts,
                [np.asarray(st.times, dtype=np.int64) for st in mods],
                [st.end_gap for st in mods],
                cons_cols,
                dict(self.outputs),
                [list(self.buffers[fid]) for fid in range(n_fifo)],
                dict(self.reader_of),
                dict(self.writer_of),
                dict(queries=self.queries, forced=self.forced,
                     phases=self.phases, activations=self.activations,
                     skipped_probes=self.skipped_probes,
                     bulk_queries=self.bulk_queries, bursts=self.bursts),
                int(len(kind_all)),
            ))
        return SimResult(
            program=program.name,
            outputs=dict(self.outputs),
            cycles=cycles,
            engine="omnisim-hybrid",
            stats=stats,
            graph=engine,
            constraints=constraints,
            depths=program.depths(),
        )


def simulate_hybrid(program: Program, max_steps: int = 50_000_000,
                    cache: Optional[HybridCache] = None,
                    periodize: bool = True) -> SimResult:
    """Segmented trace-compiled simulation for dynamic designs.

    Records and array-replays the blocking segments between NB/probe query
    points, interpreting only at the queries (paper Sec. 5.1 applied to
    Type B/C designs).  Returns a :class:`~repro_torch.core.program.SimResult`
    indistinguishable from the generator engine's, with
    ``engine="omnisim-hybrid"`` and a pre-built incremental cache so
    ``resimulate``/``resimulate_batch`` work unchanged.  ``cache`` (a
    :class:`HybridCache`) memoizes module yield streams across repeated
    simulations of the same design shape.  ``periodize`` (default True)
    enables steady-state query periodization: fixed poll loops resolve K
    definitively-false outcomes per step against the committed time tables
    instead of one generator resumption per query (disable it to benchmark
    or to cross-check the per-query path — results are bit-identical
    either way, see ``tests/test_torch_hybrid.py``).  Raises
    :class:`TraceUnsupported` on deadlocks and SPSC violations; callers
    normally go through ``repro_torch.core.simulate(..., trace="auto")``
    which falls back to the generator engine for the paper-exact report.
    """
    return HybridSim(program, cache=cache, max_steps=max_steps,
                     periodize=periodize).run()
