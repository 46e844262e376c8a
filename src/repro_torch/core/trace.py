"""Trace compilation: replay the *initial* simulation at array speed
(PyTorch-port copy of the compiled-replay half of ``repro.core.trace``).

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
     the engine falls back to the generator path (``core/engine.py``).

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

The reference's hybrid segmented replay for NB/probe designs (its
``HybridSim``/``HybridCache``) is not ported yet (ROADMAP queue 1, item 5).

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
import types
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .events import Node, NodeKind
from .program import (Delay, Emit, Empty, Fifo, Full, Program, Read, ReadNB,
                      SimResult, Write, WriteNB)

NEGI = np.int64(-(1 << 60))

# ---------------------------------------------------------------------------
# Flat op encoding (one row per recorded op).  OP_READ/OP_WRITE are the
# blocking accesses that survive into the straight-line compiled arrays —
# delays fold into the gap column, dead probes into a 1-cycle gap, Emits
# into the outputs dict.  The reference's hybrid engine (not ported yet)
# additionally records committed NB accesses (OP_READ_NB/OP_WRITE_NB),
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
    catches it and falls back to the generator engine, which handles every
    design class (paper Fig. 3, Type A/B/C).  ``dynamic`` is set when the
    only obstacle was cycle-dependent NB/probe control flow — where the
    reference takes its hybrid segmented replay (not ported yet, ROADMAP
    queue 1, item 5).
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
                    f"flow may diverge; needs the hybrid segmented replay",
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
