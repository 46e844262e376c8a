"""The OmniSim engine: coupled functionality + performance simulation.

PyTorch-port copy of ``repro.core.engine``: the event loop is host logic
and follows the reference line for line.  Faithful realization of paper
Sec. 6.2: Func Sim *threads* become deterministic coroutines, the Perf Sim
*thread* becomes the orchestrator below.  The protocol is kept exactly:

  ❶ invoke one Func Sim task per dataflow module (plus the orchestrator);
  ❷ tasks emit requests; informative ones update the partial simulation
    graph and FIFO read/write tables immediately;
  ❸ a task pauses when it issues a *query* (NB access / status probe whose
    target is unknown) or blocks on a B access; the task tracker counts
    active tasks;
  ❹ at quiescence (task tracker == 0) the orchestrator resolves queries
    earliest-cycle-first against the FIFO tables (paper Table 2); if nothing
    is resolvable it applies the earliest-query rule — the earliest pending
    query is resolved *false*, which is sound because every uncommitted
    event must eventually commit at or after that query's cycle (paper
    Sec. 7.1, proof at :meth:`OmniSim._force_earliest`);
  ❺ resolved tasks resume; on global completion the eagerly maintained node
    times are the finalized result (``verify_finalization=True`` re-derives
    them from the graph by longest path and asserts equality).

Deadlock: quiescence with no pending queries and no satisfiable blocked
access ⇒ true design-level deadlock, reported immediately with the stall
cycle (paper Sec. 7.1).

Determinism: the ready list is serviced in module order by default;
``shuffle_seed`` randomizes servicing order (Python's ``random``, so the
order is the reference's for the same seed) to demonstrate that results are
schedule-independent — the property the paper fights OS scheduling for.

Trace compilation (paper Sec. 5.1): for blocking-only runs the per-op
generator dispatch below is the dominant cost of the *initial* simulation,
so :func:`simulate` first tries ``core/trace.py`` — record each module's
op stream once, compile it to flat numpy op arrays, and replay by
array-level dispatch (chain cummax + cross-edge fixpoint) instead of
resuming generators.  Designs with live NB accesses / status probes take
the hybrid segmented replay (``trace.simulate_hybrid``); true deadlocks and
SPSC violations raise ``TraceUnsupported`` and fall back to the generator
loop in this file, which remains the semantics reference for every design
class (Type A/B/C).
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .events import Constraint, NodeKind, Query, RequestType, SimStats
from .fifo import FifoTable
from .graph import SimGraph, longest_path_numpy
from .program import (Delay, Emit, Empty, Full, Op, Program, Read, ReadNB,
                      SimResult, Write, WriteNB)


class TaskState(Enum):
    """Lifecycle of a Func Sim task (paper Sec. 6.2 ❸: a task pauses on an
    unresolvable query or a blocked blocking access)."""

    READY = 0
    PAUSED_QUERY = 1
    PAUSED_READ = 2
    PAUSED_WRITE = 3
    DONE = 4


@dataclass
class _Task:
    mid: int
    name: str
    gen: Any
    clock: int = 1                     # next available hardware cycle (1-based)
    state: TaskState = TaskState.READY
    send_value: Any = None             # value to send into the generator
    last_node: int = -1                # idx of last graph node (for seq edges)
    last_node_time: int = 0
    pending_op: Optional[Op] = None    # blocked B op or queried NB op
    pending_query: Optional[Query] = None
    started: bool = False


# Edge kinds on the simulation graph (stored as weight-tagged preds):
# we tag WAR edges so incremental re-finalization can strip/regenerate them.
SEQ, RAW, WAR = 0, 1, 2


class OmniSim:
    """Coupled Func/Perf simulation engine (paper Sec. 6.2).

    One instance = one run: module generators drive FIFO accesses, each
    committed access becomes a simulation-graph node stamped with its
    hardware **cycle**, and per-FIFO :class:`~repro.core.fifo.FifoTable`\\ s
    answer the Table-2 resolution questions.  The finished instance is
    carried on ``SimResult.graph`` and is the substrate for incremental
    (``core/incremental.py``) and batched (``core/dse.py``)
    re-simulation — the trace replay (``core/trace.py``) populates an
    identical end state without running this event loop.
    """

    def __init__(self, program: Program, shuffle_seed: Optional[int] = None,
                 max_steps: int = 50_000_000, verify_finalization: bool = False,
                 _fifo_shells: bool = False):
        self.program = program
        self.graph = SimGraph()
        # the trace replay (core/trace.py) installs every table's event
        # arrays wholesale right after construction — _fifo_shells skips
        # the per-table buffer allocations it would immediately discard
        if _fifo_shells:
            self.fifos = [FifoTable._shell(f.fid, f.name, f.depth)
                          for f in program.fifos]
        else:
            self.fifos = [FifoTable(f.fid, f.name, f.depth)
                          for f in program.fifos]
        self.tasks = [_Task(m.mid, m.name, None) for m in program.modules]
        self.outputs: Dict[str, Any] = {}
        self.stats = SimStats()
        self.constraints: List[Constraint] = []
        # min-heap of (source_time, qid, Query): earliest-query-first access
        # is O(log n) instead of the repeated full sorts of earlier revisions
        self.query_pool: List[Tuple[int, int, Query]] = []
        self._qid = 0
        self._rng = random.Random(shuffle_seed) if shuffle_seed is not None else None
        self._verify_finalization = verify_finalization
        # wake lists: O(1) unblocking instead of all-task scans
        self._waiting_reader: Dict[int, _Task] = {}
        self._waiting_writer: Dict[int, _Task] = {}
        self._wakeups: List[_Task] = []
        # tasks made READY by quiescence-time resumption/resolution; drained
        # by run() instead of rescanning every task per round (on
        # 1000-module designs the O(tasks) scans per quiescence round were
        # the dominant generator-engine cost)
        self._ready_now: List[_Task] = []
        self._n_done = 0
        self._max_steps = max_steps
        self._steps = 0
        self._war_edges: List = []       # (dst_node, src_node, fifo, w_seq)
        self.deadlock = False
        self.deadlock_cycle = -1
        # edge-kind bookkeeping for incremental re-sim
        self._edge_kinds: Dict = {}      # (dst, src) -> kind
        # SPSC endpoint enforcement: FIFO tables and query sequencing assume
        # one writer module and one reader module per FIFO (HLS semantics).
        self._writer_of: Dict[int, int] = {}
        self._reader_of: Dict[int, int] = {}

    def _check_endpoint(self, fid: int, mid: int, side: str) -> None:
        table = self._writer_of if side == "w" else self._reader_of
        prev = table.setdefault(fid, mid)
        if prev != mid:
            raise AssertionError(
                f"FIFO '{self.fifos[fid].name}' has two {side}-side modules "
                f"({self.program.modules[prev].name}, "
                f"{self.program.modules[mid].name}); FIFOs are SPSC")

    # ------------------------------------------------------------------ utils
    def _new_node(self, task: _Task, kind: NodeKind, time: int,
                  fifo: int = -1, seq: int = -1, issue: Optional[int] = None):
        """Add a node committing at ``time``.

        The SEQ edge carries only the *static-schedule* gap (issue - prev),
        never the stall component — stalls are expressed by RAW/WAR edges so
        incremental re-finalization under new FIFO depths recomputes them
        instead of baking them in.
        """
        node = self.graph.add_node(task.mid, kind, time, fifo, seq)
        if task.last_node >= 0:
            gap = (issue if issue is not None else time) - task.last_node_time
            node.add_edge(task.last_node, gap)
            self._edge_kinds[(node.idx, task.last_node)] = SEQ
        task.last_node = node.idx
        task.last_node_time = time
        self.stats.nodes += 1
        return node

    def _add_raw_edge(self, node, src_idx: int, weight: int) -> None:
        node.add_edge(src_idx, weight)
        self._edge_kinds[(node.idx, src_idx)] = RAW
        self.stats.edges += 1

    def _add_war_edge(self, node, src_idx: int, weight: int) -> None:
        node.add_edge(src_idx, weight)
        self._edge_kinds[(node.idx, src_idx)] = WAR
        self.stats.edges += 1

    # ------------------------------------------------------------------- run
    def run(self) -> SimResult:
        """Execute the protocol ❶-❺ of the module docstring to completion
        (or deadlock) and return the finalized :class:`SimResult`, whose
        ``cycles`` is the max node commit cycle."""
        # ❶ invoke all tasks
        for task, mod in zip(self.tasks, self.program.modules):
            task.gen = mod.fn()
            start = self.graph.add_node(task.mid, NodeKind.START, 0)
            task.last_node = start.idx
            task.last_node_time = 0

        live = len(self.tasks)
        ready: List[_Task] = list(self.tasks)
        while True:
            if ready:
                if self._rng is not None:
                    self._rng.shuffle(ready)
                for task in ready:
                    if task.state is TaskState.READY:
                        self._run_until_pause(task)
                ready = []
            # collect O(1) wakeups of blocked B-ops before quiescence logic
            if self._wakeups:
                for task in self._wakeups:
                    if task.state in (TaskState.PAUSED_READ,
                                      TaskState.PAUSED_WRITE):
                        op = task.pending_op
                        task.pending_op = None
                        task.state = TaskState.READY
                        okk = (self._exec_read(task, op)
                               if isinstance(op, Read)
                               else self._exec_write(task, op))
                        assert okk
                        ready.append(task)
                self._wakeups = []
                if ready:
                    continue
            # ---- quiescence ----
            self.stats.quiescence_rounds += 1
            if self._n_done == len(self.tasks):
                break
            progressed = self._resume_blocked()
            progressed |= self._resolve_queries()
            if not progressed and self.query_pool:
                self._force_earliest()
                progressed = True
            if progressed:
                # every task made READY since the last drain was appended to
                # _ready_now by _resume_blocked/_resolve_one — no task scan
                ready = self._ready_now
                self._ready_now = []
                continue
            # true design-level deadlock
            self.deadlock = True
            self.deadlock_cycle = self._current_horizon()
            blocked = [t.name for t in self.tasks if t.state is not TaskState.DONE]
            result = self._finish()
            result.deadlock = True
            result.deadlock_cycle = self.deadlock_cycle
            result.outputs["__deadlock__"] = blocked
            return result

        return self._finish()

    def _current_horizon(self) -> int:
        """Latest known cycle (committed nodes + live task clocks) — the
        stall cycle reported on deadlock (paper Sec. 7.1)."""
        h = 0
        for n in self.graph.nodes:
            if n.time > h:
                h = n.time
        for t in self.tasks:
            if t.state is not TaskState.DONE and t.clock > h:
                h = t.clock
        return h

    # ----------------------------------------------------------- task driving
    def _run_until_pause(self, task: _Task) -> None:
        """Resume ``task``'s generator and execute ops until it pauses
        (query/blocked access) or terminates.  This per-op dispatch is the
        generator path's hot loop."""
        self.stats.resumes += 1
        while True:
            self._steps += 1
            if self._steps > self._max_steps:
                raise RuntimeError(
                    f"step budget exceeded ({self._max_steps}); possible "
                    f"livelock — neither OmniSim nor co-sim detects livelock")
            try:
                if not task.started:
                    task.started = True
                    op = next(task.gen)
                else:
                    op = task.gen.send(task.send_value)
                task.send_value = None
            except StopIteration:
                self._new_node(task, NodeKind.END, task.clock)
                task.state = TaskState.DONE
                self._n_done += 1
                return
            if not self._exec_op(task, op):
                return  # paused

    def _exec_op(self, task: _Task, op: Op) -> bool:
        """Execute one op; returns True if the task may continue."""
        if isinstance(op, Delay):
            task.clock += op.cycles
            task.send_value = None
            return True
        if isinstance(op, Emit):
            self.outputs[op.key] = op.value
            task.send_value = None
            return True
        if isinstance(op, Read):
            return self._exec_read(task, op)
        if isinstance(op, Write):
            return self._exec_write(task, op)
        if isinstance(op, (ReadNB, WriteNB, Empty, Full)):
            return self._exec_query_op(task, op)
        raise TypeError(f"unknown op {op!r}")

    def _exec_read(self, task: _Task, op: Read) -> bool:
        tbl = self.fifos[op.fifo.fid]
        self._check_endpoint(op.fifo.fid, task.mid, "r")
        r = tbl.n_reads + 1
        wt = tbl.earliest_write_time(r)
        if wt is None:
            task.state = TaskState.PAUSED_READ
            task.pending_op = op
            self._waiting_reader[op.fifo.fid] = task
            return False
        u = max(task.clock, wt + 1)
        node = self._new_node(task, NodeKind.FIFO_READ, u, op.fifo.fid, r,
                              issue=task.clock)
        self._add_raw_edge(node, int(tbl.writes[r - 1]), 1)
        task.send_value = tbl.commit_read(node.idx, u)
        task.clock = u + 1
        self._wake(self._waiting_writer, op.fifo.fid)
        return True

    def _exec_write(self, task: _Task, op: Write) -> bool:
        tbl = self.fifos[op.fifo.fid]
        self._check_endpoint(op.fifo.fid, task.mid, "w")
        w = tbl.n_writes + 1
        tgt = tbl.write_target_read(w)
        if tgt is None:
            u = task.clock
            node = self._new_node(task, NodeKind.FIFO_WRITE, u, op.fifo.fid, w)
            tbl.commit_write(node.idx, u, op.value)
        else:
            rt = tbl.earliest_read_time(tgt)
            if rt is None:
                task.state = TaskState.PAUSED_WRITE
                task.pending_op = op
                self._waiting_writer[op.fifo.fid] = task
                return False
            u = max(task.clock, rt + 1)
            node = self._new_node(task, NodeKind.FIFO_WRITE, u, op.fifo.fid, w,
                                  issue=task.clock)
            src = int(tbl.reads[tgt])
            self._add_war_edge(node, src, 1)
            self._war_edges.append((node.idx, src, op.fifo.fid, w))
            tbl.commit_write(node.idx, u, op.value)
        task.send_value = None
        task.clock = u + 1
        self._maybe_wake_readers(op.fifo.fid)
        return True

    # ------------------------------------------------------------ NB / probes
    def _exec_query_op(self, task: _Task, op: Op) -> bool:
        tbl = self.fifos[op.fifo.fid]
        t = task.clock
        # dead-query elimination (paper Sec. 7.3.2): probe result unused.
        if isinstance(op, (Empty, Full)) and not op.used:
            self.stats.skipped_probes += 1
            task.clock = t + 1
            task.send_value = None
            return True
        if isinstance(op, (ReadNB, Empty)):
            rtype = (RequestType.FIFO_NB_READ if isinstance(op, ReadNB)
                     else RequestType.FIFO_CAN_READ)
            self._check_endpoint(op.fifo.fid, task.mid, "r")
            seq = tbl.n_reads + 1
            verdict = tbl.can_read_at(seq, t)
        else:
            rtype = (RequestType.FIFO_NB_WRITE if isinstance(op, WriteNB)
                     else RequestType.FIFO_CAN_WRITE)
            self._check_endpoint(op.fifo.fid, task.mid, "w")
            seq = tbl.n_writes + 1
            verdict = tbl.can_write_at(seq, t)
        self.stats.queries += 1
        if verdict is None:
            # ❸ pause on an unresolvable query
            self._qid += 1
            q = Query(self._qid, task.mid, rtype, op.fifo.fid, seq, t,
                      payload=getattr(op, "value", None))
            task.state = TaskState.PAUSED_QUERY
            task.pending_op = op
            task.pending_query = q
            heapq.heappush(self.query_pool, (q.source_time, q.qid, q))
            return False
        self._apply_query_result(task, op, rtype, seq, t, bool(verdict))
        return True

    def _apply_query_result(self, task: _Task, op: Op, rtype: RequestType,
                            seq: int, t: int, ok: bool) -> None:
        tbl = self.fifos[op.fifo.fid]
        if isinstance(op, ReadNB):
            if ok:
                node = self._new_node(task, NodeKind.FIFO_READ, t, op.fifo.fid, seq)
                # constraint edge only — NB ops never stall
                value = tbl.commit_read(node.idx, t)
                task.send_value = (True, value)
                src_node = node.idx
                self._wake(self._waiting_writer, op.fifo.fid)
            else:
                node = self._new_node(task, NodeKind.NB_FAIL, t, op.fifo.fid, seq)
                task.send_value = (False, None)
                src_node = node.idx
        elif isinstance(op, WriteNB):
            if ok:
                node = self._new_node(task, NodeKind.FIFO_WRITE, t, op.fifo.fid, seq)
                tbl.commit_write(node.idx, t, op.value)
                self._maybe_wake_readers(op.fifo.fid)
                task.send_value = True
                src_node = node.idx
            else:
                node = self._new_node(task, NodeKind.NB_FAIL, t, op.fifo.fid, seq)
                task.send_value = False
                src_node = node.idx
        else:  # Empty / Full probes
            node = self._new_node(task, NodeKind.PROBE, t, op.fifo.fid, seq)
            src_node = node.idx
            if isinstance(op, Empty):
                task.send_value = not ok       # can_read == not empty
            else:
                task.send_value = not ok       # can_write == not full
        self.constraints.append(
            Constraint(rtype, op.fifo.fid, seq, src_node, ok))
        task.clock = t + 1
        task.pending_op = None
        task.pending_query = None

    # --------------------------------------------------------- quiescence ops
    def _resume_blocked(self) -> bool:
        """At quiescence, retry every blocked blocking access whose target
        event has since committed; True if any task progressed.

        Iterates the waiting tables, not all tasks: every PAUSED_READ /
        PAUSED_WRITE task registers itself in ``_waiting_reader`` /
        ``_waiting_writer`` when it blocks, and ``_wake`` pops entries it
        hands to the wakeup queue — so the tables are exactly the blocked
        set, keyed by FIFO (unique per side under SPSC).  At 1000 modules
        this turns the per-round cost from O(tasks) into O(blocked)."""
        progressed = False
        for fid, task in list(self._waiting_reader.items()):
            if task.state is not TaskState.PAUSED_READ:
                continue                     # already queued by _wake
            tbl = self.fifos[fid]
            if tbl.earliest_write_time(tbl.n_reads + 1) is not None:
                self._waiting_reader.pop(fid, None)
                op = task.pending_op
                task.pending_op = None
                task.state = TaskState.READY
                ok = self._exec_read(task, op)
                assert ok
                self._ready_now.append(task)
                progressed = True
        for fid, task in list(self._waiting_writer.items()):
            if (task.state is not TaskState.PAUSED_WRITE
                    or self._waiting_writer.get(fid) is not task):
                continue
            tbl = self.fifos[fid]
            tgt = tbl.write_target_read(tbl.n_writes + 1)
            if tgt is None or tbl.earliest_read_time(tgt) is not None:
                self._waiting_writer.pop(fid, None)
                op = task.pending_op
                task.pending_op = None
                task.state = TaskState.READY
                ok = self._exec_write(task, op)
                assert ok
                self._ready_now.append(task)
                progressed = True
        return progressed

    def _wake(self, table: Dict[int, "_Task"], fid: int) -> None:
        task = table.pop(fid, None)
        if task is not None:
            self._wakeups.append(task)

    def _maybe_wake_readers(self, fid: int) -> None:
        self._wake(self._waiting_reader, fid)

    def _resolve_queries(self) -> bool:
        """❹ resolve all currently-definitive queries, earliest-first."""
        progressed = False
        remaining: List[Tuple[int, int, Query]] = []
        while self.query_pool:
            entry = heapq.heappop(self.query_pool)
            q = entry[2]
            tbl = self.fifos[q.fifo]
            if q.rtype in (RequestType.FIFO_NB_READ, RequestType.FIFO_CAN_READ):
                verdict = tbl.can_read_at(q.source_seq, q.source_time)
            else:
                verdict = tbl.can_write_at(q.source_seq, q.source_time)
            if verdict is None:
                remaining.append(entry)
                continue
            self._resolve_one(q, bool(verdict))
            progressed = True
        # drained in heap order, so ``remaining`` is sorted — already a valid
        # min-heap, no heapify needed
        self.query_pool = remaining
        return progressed

    def _force_earliest(self) -> None:
        """Earliest-query rule (paper Sec. 7.1, second challenge).

        Soundness: at this point every task is paused and no query/blocked
        access is definitive.  Any still-uncommitted event can only commit
        after some paused task resumes; resumptions (including this forced
        one) happen at cycles >= the earliest query's cycle t_q, hence every
        future commit has cycle >= t_q and cannot satisfy a strictly-before
        t_q comparison — the earliest query resolves *false*.
        """
        q = heapq.heappop(self.query_pool)[2]
        self.stats.queries_forced_false += 1
        self._resolve_one(q, False)

    def _resolve_one(self, q: Query, ok: bool) -> None:
        task = self.tasks[q.module]
        assert task.state is TaskState.PAUSED_QUERY and task.pending_query is q
        op = task.pending_op
        task.state = TaskState.READY
        self._apply_query_result(task, op, q.rtype, q.source_seq,
                                 q.source_time, ok)
        self._ready_now.append(task)

    # ------------------------------------------------------------- finalize
    def _finish(self) -> SimResult:
        # Finalization. The from-scratch longest-path verification is opt-in
        # (tests enable it); production runs trust the eagerly maintained
        # times — rebuilding CSR per run dominated small-design wall time.
        if self._verify_finalization and not self.deadlock:
            indptr, src, wgt, base = self.graph.to_csr()
            times = longest_path_numpy(indptr, src, wgt, base)
            eager = self.graph.times()
            if not np.array_equal(times, eager):
                bad = int(np.flatnonzero(times != eager)[0])
                raise AssertionError(
                    f"finalization mismatch at node {bad}: "
                    f"recomputed {times[bad]} vs eager {eager[bad]}")
        cycles = 0
        for node in self.graph.nodes:
            if node.time > cycles:
                cycles = node.time
        self.stats.edges = self.graph.n_edges
        return SimResult(
            program=self.program.name,
            outputs=dict(self.outputs),
            cycles=cycles,
            engine="omnisim",
            stats=self.stats,
            graph=self,
            constraints=list(self.constraints),
            depths=self.program.depths(),
        )


def simulate(program: Program, depths=None, shuffle_seed: Optional[int] = None,
             max_steps: int = 50_000_000, trace: str = "auto",
             hybrid_cache=None, periodize: bool = True) -> SimResult:
    """Run the OmniSim engine on ``program`` (optionally overriding depths).

    Mirrors ``repro.core.simulate``.  ``depths`` is written into the
    program's FIFOs in place (``Program.with_depths``), as in the
    reference.  ``trace`` selects the initial-simulation strategy:

      * ``"auto"`` (default) — try the straight-line trace-compiled replay
        (``core/trace.py``: generators entered once, op arrays replayed by
        vectorized dispatch); when the design's control flow is
        cycle-dependent (live NB accesses / status probes), drop to the
        *hybrid* segmented replay (``trace.simulate_hybrid``: blocking
        segments compiled to flat arrays, generator protocol only at the
        query points); fall back to the generator engine only when even the
        hybrid path must defer (true deadlocks, SPSC violations — the
        generator engine produces the paper-exact report).  Results are
        identical on every path.
      * ``"always"`` — compiled replay (straight-line or hybrid) or raise
        :class:`~repro_torch.core.trace.TraceUnsupported`.
      * ``"never"`` — generator engine only (the semantics reference; also
        used with ``shuffle_seed`` to exercise scheduling independence).

    ``hybrid_cache`` (a :class:`~repro_torch.core.trace.HybridCache`)
    memoizes module yield streams across repeated simulations of the same
    design shape — ``classify_dynamic`` threads one through its
    perturbed-depth probe runs, the sweep cache shares one across its cold
    builds.  ``periodize`` (default True) enables the hybrid path's
    steady-state query periodization — fixed poll loops resolve their
    definitively-false outcomes in bulk against the committed FIFO tables
    (``SimStats.queries_periodized`` counts them) — and only affects speed,
    never results.

    A non-``None`` ``shuffle_seed`` implies the generator path: the point
    of shuffling is to randomize actual task servicing order, which the
    schedule-free replay has no analogue of (``trace="always"`` plus a
    seed is contradictory and raises ``ValueError``).

    Module bodies must be *re-runnable*: ``mod.fn()`` may be invoked more
    than once per Program (an aborted trace recording falls back to the
    hybrid/generator paths, and the incremental/DSE fallbacks re-simulate
    from scratch), so bodies must not mutate shared closure state or perform
    external side effects.
    """
    if trace not in ("auto", "always", "never"):
        raise ValueError(f"trace must be 'auto'|'always'|'never', got {trace!r}")
    if trace == "always" and shuffle_seed is not None:
        raise ValueError("trace='always' is incompatible with shuffle_seed: "
                         "the schedule-free replay has no servicing order "
                         "to shuffle")
    if depths is not None:
        program.with_depths(depths)
    if trace != "never" and shuffle_seed is None:
        from . import trace as _trace
        try:
            return _trace.simulate_traced(program, max_steps=max_steps)
        except _trace.TraceUnsupported as exc:
            if exc.dynamic:
                try:
                    return _trace.simulate_hybrid(program, max_steps=max_steps,
                                                  cache=hybrid_cache,
                                                  periodize=periodize)
                except _trace.TraceUnsupported:
                    if trace == "always":
                        raise        # the hybrid verdict is the precise one
            elif trace == "always":
                raise
    return OmniSim(program, shuffle_seed=shuffle_seed, max_steps=max_steps).run()
