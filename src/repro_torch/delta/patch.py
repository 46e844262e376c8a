"""Trace and graph patching: re-record only the edited modules.

The cold trace path (``core/trace.py``) records *every* module generator,
then compiles and solves.  For an edit that touches one module of a
300-module design that is 299 re-recordings too many.  This module keeps a
:class:`DeltaState` snapshot of the last recorded run — op rows *plus* the
functional capture (per-FIFO written-value streams, per-module emits) —
and on an edit:

1. re-runs **only** the edited modules' generators in a KPN sandbox whose
   Reads are fed from the recorded value streams;
2. requires each edited module's **write streams to be byte-identical** to
   the recorded ones.  Under KPN determinism that equality proves every
   unchanged module's functional behavior is unchanged (their inputs are
   literally the same values), so splicing their recorded rows is *exact*
   — any deviation (different values, counts, targets, a live NB op, a
   read past the recorded stream) rejects to a cold rebuild;
3. splices the re-recorded rows into the compiled skeleton — patching only
   the edited modules' SEQ weights in place when their op structure is
   unchanged, recompiling the (numpy-cheap) skeleton otherwise — and
   re-solves;
4. re-verifies the solved times with the pointwise max-plus + Table-2 pass
   (``core.incremental.verify_times``, the hybrid replay's ``_FullRun``
   verifier pattern).  A verified solution is *the* solution; a failed verification
   rejects to cold.

The result is bit-identical to a cold ``simulate`` of the edited design or
it is not served at all.
"""
from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.program import (Delay, Emit, Empty, Full, Program, Read, ReadNB,
                            SimResult, Write, WriteNB)
from ..core.trace import (OP_READ, OP_WRITE, CompiledTrace, ModuleTrace,
                          RecordedTrace, TraceUnsupported,
                          build_traced_result, compile_trace, record_trace,
                          _cross_buckets, _solve_times, to_compiled_graph)
from ..core.incremental import verify_times
from .fingerprint import (UNCHANGED, DesignDelta, DesignFingerprint, diff,
                          fingerprint_design)

__all__ = ["DeltaState", "PatchOutcome", "PatchReject", "snapshot",
           "apply_patch", "cold_build"]


class PatchReject(Exception):
    """The delta cannot be patched soundly — fall back to a cold rebuild.

    Never an error condition: rejection is the verifier doing its job.
    """


@dataclass
class DeltaState:
    """Reusable snapshot of one recorded design: fingerprint table, the
    value-carrying :class:`RecordedTrace`, the compiled skeleton, and the
    solved node times + depth vector they were solved under (the warm
    seed for the next patch's fixpoint)."""

    fps: DesignFingerprint
    rec: RecordedTrace              # recorded with keep_values=True
    ct: CompiledTrace
    program: Program
    times: Optional[np.ndarray] = None
    depths: Optional[Tuple[int, ...]] = None
    # solver cross-edge buckets (``core.trace._cross_buckets``) — valid
    # for this skeleton + this depth vector's WAR edges; reused by pure
    # timing patches so the warm solve skips bucket reconstruction
    buckets: Optional[dict] = None


@dataclass
class PatchOutcome:
    """Result of one :func:`apply_patch` attempt."""

    ok: bool
    mode: str                       # "seqw" | "recompiled" | "rejected"
    reason: str
    result: Optional[SimResult]
    state: Optional["DeltaState"]
    reused_modules: int
    edited_modules: int
    total_modules: int
    elapsed_s: float

    @property
    def reuse_fraction(self) -> float:
        return self.reused_modules / max(self.total_modules, 1)


def snapshot(program: Program, max_steps: int = 50_000_000,
             fps: Optional[DesignFingerprint] = None,
             ) -> Tuple[SimResult, DeltaState]:
    """Cold record + compile + solve, capturing the delta state.

    One pass: functionally identical to ``simulate_traced`` (same
    ``SimResult``, ``engine="omnisim-trace"``) but records with
    ``keep_values=True`` so subsequent edits can be patched.  Raises
    :class:`TraceUnsupported` for dynamic designs — callers fall back to
    ``simulate`` with no delta state.  ``fps`` lets callers that already
    fingerprinted the design (the cache lookup did, to classify the edit)
    skip re-hashing it here.
    """
    rec = record_trace(program, max_steps, keep_values=True)
    ct = compile_trace(rec, len(program.fifos))
    depths = program.depths()
    war_dst, war_src = ct.war_edges(depths)
    starts = np.asarray([lo for (lo, _) in ct.slices] or [0], np.int64)
    buckets = _cross_buckets(ct, war_dst, war_src, starts)
    times, sweeps = _solve_times(ct, war_dst, war_src, buckets=buckets)
    res = build_traced_result(program, rec, ct, times, war_dst, war_src,
                              sweeps)
    state = DeltaState(fps=fps or fingerprint_design(program), rec=rec,
                       ct=ct, program=program, times=times,
                       depths=tuple(int(d) for d in depths),
                       buckets=buckets)
    return res, state


def cold_build(program: Program, hybrid_cache=None,
               max_steps: int = 50_000_000,
               fps: Optional[DesignFingerprint] = None,
               ) -> Tuple[SimResult, Optional[DeltaState]]:
    """Cold build with best-effort delta capture.

    Traceable (blocking-only) designs go through :func:`snapshot` and
    return a :class:`DeltaState`; dynamic designs fall back to the normal
    ``simulate`` front door (threaded through ``hybrid_cache`` so the
    sweep cache's shared :class:`~repro_torch.core.trace.HybridCache` learns the
    run) and return ``state=None``.
    """
    try:
        return snapshot(program, max_steps, fps=fps)
    except TraceUnsupported:
        from ..core.engine import simulate
        return simulate(program, max_steps=max_steps,
                        hybrid_cache=hybrid_cache), None


def _val_eq(a, b) -> bool:
    """Robust payload equality (ndarray payloads compare by content)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    try:
        return bool(a == b)
    except Exception:
        return False


class _Rerecord:
    """One edited module's sandbox re-recording."""

    __slots__ = ("kind", "fifo", "gap", "end_gap", "writes", "reads",
                 "emits", "skips")

    def __init__(self, kind, fifo, gap, end_gap, writes, reads, emits,
                 skips):
        self.kind = kind
        self.fifo = fifo
        self.gap = gap
        self.end_gap = end_gap
        self.writes = writes        # fid -> [values written]
        self.reads = reads          # fid -> count consumed
        self.emits = emits          # [(key, value)]
        self.skips = skips          # dead probes


def _rerecord_module(module, values: List[list],
                     max_steps: int) -> _Rerecord:
    """Run one module generator in isolation, Reads fed from the recorded
    per-FIFO value streams (sound by KPN determinism *if* the module's own
    writes verify against the recorded streams — the caller checks)."""
    gen = module.fn()
    kinds: List[int] = []
    fids: List[int] = []
    gaps: List[int] = []
    writes: Dict[int, list] = {}
    reads: Dict[int, int] = {}
    emits: List[tuple] = []
    skips = 0
    gap = 1
    send = None
    steps = 0
    while True:
        steps += 1
        if steps > max_steps:
            raise PatchReject(
                f"module '{module.name}': step budget exceeded re-recording")
        try:
            op = gen.send(send)
        except StopIteration:
            end_gap = gap
            break
        send = None
        cls = op.__class__
        if cls is Read:
            fid = op.fifo.fid
            pos = reads.get(fid, 0)
            stream = values[fid] if fid < len(values) else []
            if pos >= len(stream):
                raise PatchReject(
                    f"module '{module.name}' reads past the recorded "
                    f"stream of FIFO '{op.fifo.name}' — would block")
            send = stream[pos]
            reads[fid] = pos + 1
            kinds.append(OP_READ)
            fids.append(fid)
            gaps.append(gap)
            gap = 1
        elif cls is Write:
            fid = op.fifo.fid
            writes.setdefault(fid, []).append(op.value)
            kinds.append(OP_WRITE)
            fids.append(fid)
            gaps.append(gap)
            gap = 1
        elif cls is Delay:
            gap += op.cycles
        elif cls is Emit:
            emits.append((op.key, op.value))
        elif (cls is Empty or cls is Full) and not op.used:
            skips += 1
            gap += 1
        elif cls in (ReadNB, WriteNB, Empty, Full):
            raise PatchReject(
                f"module '{module.name}' issues {cls.__name__} — "
                f"cycle-dependent, not patchable")
        else:
            raise PatchReject(f"module '{module.name}': unknown op {op!r}")
    return _Rerecord(
        kind=np.asarray(kinds, dtype=np.int8),
        fifo=np.asarray(fids, dtype=np.int64),
        gap=np.asarray(gaps, dtype=np.int64),
        end_gap=end_gap, writes=writes, reads=reads, emits=emits,
        skips=skips)


def _module_write_fids(mt: ModuleTrace) -> set:
    kind, fifo, _ = mt.expand()
    return set(int(f) for f in np.unique(fifo[kind == OP_WRITE]))


def apply_patch(state: DeltaState, new_program: Program,
                delta: Optional[DesignDelta] = None,
                max_steps: int = 50_000_000,
                new_fps: Optional[DesignFingerprint] = None) -> PatchOutcome:
    """Patch ``state`` into a verified result for ``new_program``.

    Returns ``ok=False`` (with a reason) instead of raising when the delta
    is not patchable or fails verification — the caller falls back to
    :func:`cold_build`.  A returned ``ok=True`` outcome carries a result
    bit-identical to a cold run plus the refreshed :class:`DeltaState`.
    ``new_fps`` (and ``delta``) let the serving path hash and classify
    once instead of per tier.
    """
    t0 = _time.perf_counter()
    if new_fps is None:
        new_fps = fingerprint_design(new_program)
    if delta is None:
        delta = diff(state.fps, new_fps)
    total = len(new_program.modules)

    def _reject(reason: str) -> PatchOutcome:
        return PatchOutcome(ok=False, mode="rejected", reason=reason,
                            result=None, state=None, reused_modules=0,
                            edited_modules=len(delta.edited),
                            total_modules=total,
                            elapsed_s=_time.perf_counter() - t0)

    if not delta.patchable:
        return _reject(delta.reason or "delta not patchable")
    if state.rec.values is None:
        return _reject("snapshot lacks value capture")

    old_rec = state.rec
    values = old_rec.values
    name_to_mid = {m.name: i for i, m in enumerate(new_program.modules)}
    edited_mids = sorted(name_to_mid[nm] for nm in delta.edited)
    try:
        new_modules = list(old_rec.modules)
        new_emits = list(old_rec.module_emits or [[]] * total)
        new_skips = list(old_rec.module_skips or [0] * total)
        structure_same = True
        reads_delta: Dict[int, int] = {}    # fid -> edited read-count change
        for mid in edited_mids:
            module = new_program.modules[mid]
            rr = _rerecord_module(module, values, max_steps)
            old_mt = old_rec.modules[mid]
            # --- write verification: the KPN-determinism soundness gate.
            # SPSC means this module was the sole writer of each FIFO it
            # wrote, so its recorded per-FIFO write stream is the whole
            # values[fid] stream — require exact equality.
            if set(rr.writes) != _module_write_fids(old_mt):
                raise PatchReject(
                    f"module '{module.name}' writes a different FIFO set")
            for fid, ws in rr.writes.items():
                old_ws = values[fid]
                if len(ws) != len(old_ws) or not all(
                        _val_eq(a, b) for a, b in zip(ws, old_ws)):
                    raise PatchReject(
                        f"module '{module.name}' write stream diverged on "
                        f"FIFO {fid} — functional change, not a timing "
                        f"edit")
            ok_kind, ok_fifo, _ = old_mt.expand()
            if (len(rr.kind) != len(ok_kind)
                    or not np.array_equal(rr.kind, ok_kind)
                    or not np.array_equal(rr.fifo, ok_fifo)):
                structure_same = False
            old_rf = ok_fifo[ok_kind == OP_READ]
            for fid, cnt in zip(*np.unique(old_rf, return_counts=True)):
                reads_delta[int(fid)] = reads_delta.get(int(fid), 0) \
                    - int(cnt)
            for fid, cnt in rr.reads.items():
                reads_delta[fid] = reads_delta.get(fid, 0) + cnt
            new_modules[mid] = ModuleTrace(
                mid=mid, name=module.name, kind=rr.kind, fifo=rr.fifo,
                gap=rr.gap, end_gap=rr.end_gap).periodize()
            new_emits[mid] = list(rr.emits)
            new_skips[mid] = rr.skips

        # functional splice: leftovers from total read counts — derived
        # incrementally (old totals from the recorded leftovers, adjusted
        # by the edited modules' read-count change) so the splice is
        # O(edited), not O(all modules) — outputs from per-module emit
        # lists, dead-probe totals from per-module counts
        n_fifos = len(new_program.fifos)
        reads_total = [len(values[fid]) - len(old_rec.leftovers[fid])
                       for fid in range(n_fifos)]
        for fid, d in reads_delta.items():
            reads_total[fid] += d
        for fid in range(n_fifos):
            if reads_total[fid] > len(values[fid]) or reads_total[fid] < 0:
                raise PatchReject(
                    f"FIFO {fid}: spliced reads ({reads_total[fid]}) exceed "
                    f"recorded writes ({len(values[fid])})")
        leftovers = [list(values[fid][reads_total[fid]:])
                     for fid in range(n_fifos)]
        outputs: Dict[str, Any] = {}
        for em in new_emits:
            for k, v in em:
                outputs[k] = v
        new_rec = RecordedTrace(
            program=new_program.name, modules=new_modules, outputs=outputs,
            leftovers=leftovers, skipped_probes=sum(new_skips),
            steps=old_rec.steps, activations=old_rec.activations,
            values=values, module_emits=new_emits, module_skips=new_skips)

        # graph splice: patch SEQ weights in place when the edited modules'
        # op structure is unchanged (pure timing edit), else recompile the
        # numpy-cheap skeleton from the spliced rows
        if structure_same:
            seq_w = state.ct.seq_w.copy()
            for mid in edited_mids:
                lo, hi = state.ct.slices[mid]
                _, _, gaps = new_modules[mid].expand()
                seq_w[lo + 1:hi - 1] = gaps
                seq_w[hi - 1] = new_modules[mid].end_gap
            ct = dataclasses.replace(state.ct, seq_w=seq_w, trace=new_rec)
            mode = "seqw"
        else:
            ct = compile_trace(new_rec, n_fifos)
            mode = "recompiled"

        depths = new_program.depths()
        war_dst, war_src = ct.war_edges(depths)
        # warm-start the fixpoint from the old solution when the graph
        # skeleton and depth vector are unchanged (pure timing edit):
        # only the edited chains start dirty, so the solve cost tracks
        # the edit's cone of influence, not the design.  Sound for weight
        # increases; a decrease can overshoot the least fixpoint, which
        # the pointwise verification below catches — then we re-solve
        # cold once before giving up.
        warm_ok = (mode == "seqw" and state.times is not None
                   and state.depths == tuple(int(d) for d in depths))
        # when additionally no SEQ weight *decreased*, the old solution is
        # a provable lower bound of the new least fixpoint (same node set,
        # pointwise-larger weights), and ascending Gauss-Seidel from any
        # lower bound lands exactly on the least fixpoint — the same
        # solution the cold NEGI-seeded solve computes.  The pointwise
        # check is then mathematically redundant and skipped; any other
        # shape of patch still verifies before being served.  (The
        # differential suite pins this equivalence bit-for-bit.)
        monotone = warm_ok and bool(np.all(ct.seq_w >= state.ct.seq_w))
        if warm_ok and state.buckets is not None:
            # same skeleton + same depths => identical cross-edge content:
            # reuse the snapshot's bucket table
            buckets = state.buckets
        else:
            starts = np.asarray([lo for (lo, _) in ct.slices] or [0],
                                np.int64)
            buckets = _cross_buckets(ct, war_dst, war_src, starts)
        if warm_ok:
            times, sweeps = _solve_times(ct, war_dst, war_src,
                                         warm=(state.times, edited_mids),
                                         buckets=buckets)
        else:
            times, sweeps = _solve_times(ct, war_dst, war_src,
                                         buckets=buckets)
        graph = to_compiled_graph(ct)
        if not monotone:
            err = verify_times(graph, times, depths)
            if err is not None and warm_ok:
                times, sweeps = _solve_times(ct, war_dst, war_src)
                err = verify_times(graph, times, depths)
            if err is not None:
                raise PatchReject(f"verification failed: {err}")
    except PatchReject as e:
        return _reject(str(e))
    except TraceUnsupported as e:
        return _reject(f"splice not trace-compilable: {e}")

    res = build_traced_result(new_program, new_rec, ct, times, war_dst,
                              war_src, sweeps, graph=graph)
    new_state = DeltaState(fps=new_fps, rec=new_rec, ct=ct,
                           program=new_program, times=times,
                           depths=tuple(int(d) for d in depths),
                           buckets=buckets)
    return PatchOutcome(
        ok=True, mode=mode, reason="", result=res, state=new_state,
        reused_modules=total - len(edited_mids),
        edited_modules=len(edited_mids), total_modules=total,
        elapsed_s=_time.perf_counter() - t0)
