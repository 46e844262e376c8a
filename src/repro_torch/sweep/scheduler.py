"""Continuous batching of depth-vector requests over warm compiled graphs.

PyTorch port of ``repro.sweep.scheduler``.  The serving loop of
``serve/engine.py::ContinuousBatchingEngine`` — admit work into the next
batch as slots free up, keep the expensive kernel hot — transplanted onto
the DSE solver.  The unit of execution here is a *block*:
up to ``block`` depth rows against ONE design, assembled fresh each step
from however many client requests are queued (heterogeneous requests
against the same design coalesce into shared blocks), deduplicated down to
unique rows, solved by :func:`repro_torch.core.dse.solve_block_status`
(by default on the card, through the sparse max-plus CUDA kernel), and
streamed back **per config** — a client starts receiving results for its
first rows while its later rows are still queued behind other tenants.

Scheduling policy:

  * two lanes — ``"interactive"`` (small requests) and ``"bulk"``.  The
    interactive lane is always served first, so a 4-config what-if query
    lands in the very next block even while a 10^5-config sweep is
    draining; after ``starvation_limit`` consecutive interactive blocks
    one bulk block is forced through, so a flood of interactive queries
    cannot starve bulk sweeps either.
  * within a lane, requests are FIFO; a block anchors on the oldest live
    request and pulls same-design rows from every queued request (both
    lanes) to fill up — the cross-tenant coalescing that makes the batch
    solver earn its keep.
  * identical depth rows inside a block (across tenants!) are solved
    once; every duplicate row is answered from the same solve.

Sharding: a block's unique rows are split across ``shards`` workers —
``mode="thread"`` (all workers share the warm ``_BatchArrays`` view and
its device arrays; on one card their launches go to the same default
stream and run one after another) or ``mode="process"`` (workers hold
their own unpickled :class:`~repro_torch.core.incremental.CompiledGraph`
per design key, each with its own CUDA context and device copies).
Process pools start their workers with ``spawn``: a forked child cannot
use CUDA once the parent has initialised it.  Chunks are concatenated in
submission order, so results are bit-identical for every
``shards``/``mode`` setting.  Process pools are seeded through a *pool
initializer*: the host keeps a bounded LRU of pickled graphs per design
key, every (re)spawned worker unpickles them once at startup, and a task
ships only the design key — a worker that has never seen the key answers
with a need-blob sentinel and the host resends that one chunk with the
blob attached, so steady state, retries and respawns never re-pay graph
serialization per task.

Exactness: a block's verdicts and cycle counts are exactly
``resimulate_batch``'s — REUSED rows from the shared fixpoint, failed rows
(deadlock / WAR cycle / constraint flip) through the same full
re-simulation fallback (run once per unique row, on the scheduler thread,
under the design's entry lock because it temporarily mutates Program FIFO
depths).

Device faults surface at construction: :class:`BlockScheduler` resolves
its device and, on a CUDA device, loads (building if needed) the chosen
lane's kernel library, so a missing card or a failed ``nvcc`` build raises
there instead of reaching clients as ``FAULTED`` rows.  Workers only load
the library the constructor built (its file name carries the source's
digest), so a shard's first solve never pays for a build.

Fault tolerance: a shard that faults, times out or returns corrupt
arrays is retried on the surviving pool under the
:class:`~repro_torch.sweep.faults.RetryPolicy` (exponential backoff,
clipped to the requests' remaining deadline budget); on exhaustion only
that
*shard's* rows terminate — ``FAULTED`` or ``TIMED_OUT`` — while the rest
of the block (and every other tenant) delivers normally.  A broken worker
pool (``BrokenExecutor``) is respawned up to ``max_pool_respawns`` times.
Per-request deadlines (``deadline_s``) are enforced end-to-end: at
scheduling, while waiting on shards, and at delivery — an expired
request's undelivered rows terminate as ``TIMED_OUT``, never hang.
Repeated solve faults for one design strike its
:class:`~repro_torch.sweep.faults.DesignQuarantine` circuit breaker; a
tripped design's queued rows fail fast so co-scheduled tenants keep being
served.
Every fault path preserves the golden invariant: rows that ARE delivered
stay bit-identical to the generator engine.

Cancellation: a cancelled request stops being scheduled at the next block
boundary; rows already solved are dropped, the client's stream is closed
with a terminal sentinel, and undelivered rows surface as ``CANCELLED`` in
the assembled outcome.
"""
from __future__ import annotations

import multiprocessing
import pickle
import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import BrokenExecutor, CancelledError
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import obs
from ..core.dse import (BACKENDS, CANCELLED, FAULTED, REUSED, TIMED_OUT,
                        materialize_block, solve_block_status)
from ..core.program import SimResult
from ..kernels import _cuda
from .cache import CacheEntry
from .faults import (POOL_BROKEN, SHARD_CORRUPT, SHARD_FAULT, SHARD_HANG,
                     DesignQuarantine, FaultInjector, InjectedFault,
                     RetryPolicy, _PoolBrokenFault)

INTERACTIVE, BULK = "interactive", "bulk"

_DONE = object()                     # per-request stream terminator


class ShardCorruption(ValueError):
    """A shard returned result arrays that do not match its chunk — the
    host-side validation that keeps a corrupting worker from ever
    delivering wrong verdicts (treated as a retryable shard fault)."""


class ConfigResult(NamedTuple):
    """One streamed per-config verdict (exactly ``resimulate_batch``'s)."""

    request_id: int
    index: int                       # row in the request's depth matrix
    depths: Tuple[int, ...]
    ok: bool
    status: int                      # REUSED/DEADLOCK/CYCLE/VIOLATED/...
    cycles: int                      # exact; -1 if fallback was disabled
    violated: int                    # flipped constraint outcomes
    reason: str
    result: Optional[SimResult]


class _Request:
    __slots__ = ("rid", "entry", "D", "K", "fallback", "priority", "out_q",
                 "cancelled", "cursor", "delivered", "finalized", "error",
                 "t_submit", "tenant", "t_deadline", "on_finalize",
                 "reject_reason")

    def __init__(self, rid: int, entry: Optional[CacheEntry], D: np.ndarray,
                 priority: str, fallback: bool, out_q,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None,
                 on_finalize=None):
        self.rid = rid
        self.entry = entry
        self.D = D
        self.K = len(D)
        self.fallback = fallback
        self.priority = priority
        self.out_q = out_q
        self.cancelled = threading.Event()
        self.cursor = 0              # rows handed to blocks so far
        self.delivered = 0
        self.finalized = False
        self.error: Optional[str] = None   # set when aborted by a fault
        self.t_submit = _time.perf_counter()
        self.tenant = tenant
        self.t_deadline = (self.t_submit + deadline_s
                           if deadline_s is not None else None)
        self.on_finalize = on_finalize
        self.reject_reason: Optional[str] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.t_deadline is None:
            return False
        return (now if now is not None
                else _time.perf_counter()) > self.t_deadline


class _Block(NamedTuple):
    entry: CacheEntry
    items: List[Tuple[_Request, int]]    # (request, row index) per row
    lane: str


class _Attempt(NamedTuple):
    fut: object                      # Future, or None for the inline path
    call: object                     # zero-arg callable, or None
    gen: int                         # pool generation the future targets


# ---------------------------------------------------------------- workers
# Worker-side graph cache for mode="process": each worker unpickles a
# design's CompiledGraph once (at pool-initializer time for every design
# the host has already sharded, or on first need-blob round trip for a
# design that appears later) and keeps it warm across blocks, retries and
# respawns.  Bounded LRU: host-side GraphCache evictions never reach the
# workers, so an unbounded dict would leak one graph per design ever
# swept.
_WORKER_GRAPHS: "OrderedDict[str, object]" = OrderedDict()
_WORKER_GRAPHS_CAP = 16

# sentinel result (a plain string: it must survive pickling by value) a
# worker returns when a task names a graph it does not hold — the host
# resends that chunk once with the blob attached
_NEED_BLOB = "__sweep_need_graph_blob__"


def _worker_init(entries) -> None:
    """Process-pool initializer: unpickle every known design graph once
    per worker, so tasks (and retries, and respawned pools) ship only the
    design key."""
    for key, blob in entries:
        if key not in _WORKER_GRAPHS:
            _WORKER_GRAPHS[key] = pickle.loads(blob)
    while len(_WORKER_GRAPHS) > _WORKER_GRAPHS_CAP:
        _WORKER_GRAPHS.popitem(last=False)


def _apply_shard_faults(out, hang_s: float, boom: bool, corrupt: bool):
    if hang_s:
        _time.sleep(hang_s)
    if boom:
        raise InjectedFault(SHARD_FAULT, -1)
    if corrupt and len(out[0]):
        return (out[0][:-1], out[1][:-1], out[2][:-1], out[3])
    return out


@obs.traced("sweep.shard")
def _shard_task(graph, Db: np.ndarray, backend: str, block: int,
                hang_s: float = 0.0, boom: bool = False,
                corrupt: bool = False, device: str = "cuda"):
    """Thread/serial shard unit: solve one chunk (plus injected faults —
    the injector draws on the scheduler thread, deterministically, and
    ships only the outcome flags here)."""
    if hang_s:
        _time.sleep(hang_s)
    if boom:
        raise InjectedFault(SHARD_FAULT, -1)
    out = solve_block_status(graph, Db, backend=backend, block=block,
                             device=device)
    return _apply_shard_faults(out, 0.0, False, corrupt)


def _process_shard_solve(key: str, blob: Optional[bytes], Db: np.ndarray,
                         backend: str, block: int, hang_s: float = 0.0,
                         boom: bool = False, corrupt: bool = False,
                         device: str = "cuda"):
    graph = _WORKER_GRAPHS.get(key)
    if graph is None:
        if blob is None:
            return _NEED_BLOB          # host resends this chunk with the blob
        graph = pickle.loads(blob)
        _WORKER_GRAPHS[key] = graph
        while len(_WORKER_GRAPHS) > _WORKER_GRAPHS_CAP:
            _WORKER_GRAPHS.popitem(last=False)
    else:
        _WORKER_GRAPHS.move_to_end(key)
    if hang_s:
        _time.sleep(hang_s)
    if boom:
        raise InjectedFault(SHARD_FAULT, -1)
    out = solve_block_status(graph, Db, backend=backend, block=block,
                             device=device)
    return _apply_shard_faults(out, 0.0, False, corrupt)


class BlockScheduler:
    """Lane-based continuous batching of sweep requests (see module doc).

    ``backend`` is one of ``core.dse.BACKENDS``; ``device`` is where the
    ``"cuda"``/``"cuda_dense"`` lanes run (a CUDA device by default,
    which must exist; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, block: int = 128, shards: int = 1,
                 mode: str = "thread", starvation_limit: int = 4,
                 backend: str = "cuda", min_shard_rows: int = 8,
                 retry: Optional[RetryPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 shard_timeout_s: Optional[float] = 30.0,
                 quarantine: Optional[DesignQuarantine] = None,
                 max_pool_respawns: int = 2,
                 device="cuda",
                 memo_capacity: int = 4096):
        if mode not in ("serial", "thread", "process"):
            raise ValueError(f"unknown mode {mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        # the device lanes fail here, not as FAULTED rows: no card, or a
        # kernel library that does not build
        self.device = "cpu"
        if backend in ("cuda", "cuda_dense"):
            dev = _cuda.resolve_device(device)
            self.device = str(dev)
            if dev.type == "cuda":
                (_cuda.SPARSE if backend == "cuda" else _cuda.DENSE).lib()
        self.block = max(int(block), 1)
        self.shards = max(int(shards), 1)
        self.mode = mode if self.shards > 1 else "serial"
        self.starvation_limit = max(int(starvation_limit), 1)
        self.backend = backend
        self.min_shard_rows = min_shard_rows
        self.retry = retry if retry is not None else RetryPolicy()
        self.injector = injector
        self.shard_timeout_s = shard_timeout_s
        self.quarantine = (quarantine if quarantine is not None
                           else DesignQuarantine())
        self.max_pool_respawns = max(int(max_pool_respawns), 0)
        self._lanes: Dict[str, deque] = {INTERACTIVE: deque(),
                                         BULK: deque()}
        self._cv = threading.Condition()
        self._consec_interactive = 0
        # pickled graphs per design key, fed to process-pool initializers
        # so respawned workers start warm (bounded like the worker cache)
        self._pool_blobs: "OrderedDict[str, bytes]" = OrderedDict()
        self._pool_gen = 0
        self._pool = self._make_pool()
        # cross-block memo of exact repeat configs: (design key, depth-row
        # bytes) -> (status, cycles, violated).  Content-addressed like the
        # graph cache, so it stays valid across entry eviction/rebuild and
        # across design edits (an edited design has a new key).  Bounded
        # LRU; 0 disables.  FAULTED/TIMED_OUT verdicts are transient and
        # never memoized.
        self.memo_capacity = max(int(memo_capacity), 0)
        self._memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        # shared HybridCache (set by SweepService from its GraphCache):
        # threaded into fallback re-simulations so repeat fallbacks of a
        # dynamic design replay its spilled verified whole run
        self.hybrid = None
        # counters (guarded by _cv's lock)
        self.stats_blocks = 0
        self.stats_blocks_interactive = 0
        self.stats_blocks_bulk = 0
        self.stats_rows = 0              # rows placed into blocks
        self.stats_rows_unique = 0       # rows actually solved
        self.stats_fallbacks = 0         # full re-simulations run
        self.stats_cancelled_rows = 0
        self.stats_requests = 0
        self.stats_retries = 0           # shard attempts beyond the first
        self.stats_faulted_rows = 0      # rows terminally FAULTED
        self.stats_timed_out_rows = 0    # rows terminally TIMED_OUT
        self.stats_pool_respawns = 0
        self.stats_blob_reships = 0      # need-blob round trips (process)
        self.stats_memo_hits = 0         # rows answered without a solve

    # --------------------------------------------------------------- pool
    def _make_pool(self):
        if self.mode == "thread":
            from concurrent.futures import ThreadPoolExecutor
            return ThreadPoolExecutor(max_workers=self.shards,
                                      thread_name_prefix="sweep-shard")
        if self.mode == "process":
            from concurrent.futures import ProcessPoolExecutor
            return ProcessPoolExecutor(
                max_workers=self.shards,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(tuple(self._pool_blobs.items()),))
        return None

    def _respawn_pool(self) -> bool:
        """Replace a broken pool (bounded); False once the budget is
        spent — the caller then fails its chunk instead of looping."""
        if self.stats_pool_respawns >= self.max_pool_respawns:
            return False
        self.stats_pool_respawns += 1
        old = self._pool
        self._pool_gen += 1
        self._pool = self._make_pool()
        if old is not None:
            try:
                old.shutdown(wait=False, cancel_futures=True)
            except Exception:      # a broken pool may refuse even shutdown
                pass
        return True

    def _submit(self, fn, *args):
        """Pool submit that converts a broken-at-submit pool into a
        failed future — _collect's respawn path handles both the same."""
        try:
            return self._pool.submit(fn, *args)
        except (BrokenExecutor, RuntimeError) as exc:
            from concurrent.futures import Future
            fut = Future()
            fut.set_exception(exc if isinstance(exc, BrokenExecutor)
                              else BrokenExecutor(str(exc)))
            return fut

    def _register_blob(self, entry: CacheEntry) -> bytes:
        blob = entry.graph_blob()
        self._pool_blobs[entry.key] = blob
        self._pool_blobs.move_to_end(entry.key)
        while len(self._pool_blobs) > _WORKER_GRAPHS_CAP:
            self._pool_blobs.popitem(last=False)
        return blob

    # ------------------------------------------------------------- intake
    def submit(self, request: _Request) -> None:
        with self._cv:
            self._lanes[request.priority].append(request)
            self.stats_requests += 1
            self._cv.notify_all()

    def kick(self) -> None:
        """Wake the loop (e.g. after a cancellation) so terminal sentinels
        are delivered promptly."""
        with self._cv:
            self._cv.notify_all()

    # ----------------------------------------------------------- assembly
    def _finish(self, req: _Request) -> None:
        """Deliver the terminal sentinel exactly once and release the
        request's admission reservation."""
        if req.finalized:
            return
        req.finalized = True
        req.out_q.put(_DONE)
        if req.on_finalize is not None:
            try:
                req.on_finalize(req)
            except Exception:        # bookkeeping must not kill the loop
                pass

    def _finalize(self, req: _Request) -> None:
        if not req.finalized:
            self.stats_cancelled_rows += req.K - req.delivered
            self._finish(req)

    def _fail_tail(self, req: _Request, status: int, reason: str) -> None:
        """Terminate every not-yet-scheduled row of ``req`` with a
        definite status (FAULTED / TIMED_OUT) and close its stream."""
        n = req.K - req.cursor
        for i in range(req.cursor, req.K):
            req.out_q.put(ConfigResult(
                request_id=req.rid, index=i,
                depths=tuple(int(d) for d in req.D[i]),
                ok=False, status=int(status), cycles=-1, violated=0,
                reason=reason, result=None))
            req.delivered += 1
        req.cursor = req.K
        if status == TIMED_OUT:
            self.stats_timed_out_rows += n
        elif status == FAULTED:
            self.stats_faulted_rows += n
        self._finish(req)

    def _reap_cancelled(self, lane: deque) -> None:
        # reap ANYWHERE in the lane, not just the front: a cancelled
        # request's stream must close at the next scheduling point even
        # with a long bulk queue ahead of it
        for req in [r for r in lane if r.cancelled.is_set()]:
            lane.remove(req)
            self._finalize(req)

    def _reap_expired(self, lane: deque) -> None:
        now = _time.perf_counter()
        for req in [r for r in lane if r.expired(now)]:
            lane.remove(req)
            self._fail_tail(req, TIMED_OUT,
                            "deadline exceeded before this config was "
                            "scheduled")

    def _reap_quarantined(self, lane: deque) -> None:
        for req in [r for r in lane
                    if r.entry is not None
                    and self.quarantine.is_quarantined(r.entry.key)]:
            lane.remove(req)
            why = self.quarantine.reason(req.entry.key)
            self._fail_tail(req, FAULTED,
                            "design quarantined after repeated solve "
                            f"faults{': ' + why if why else ''}")

    def abort_pending(self, message: str) -> None:
        """Fail every queued request (scheduler fault or service close):
        mark the error and deliver the terminal sentinel so no client
        blocks forever on a stream that will never finish."""
        with self._cv:
            for lane in self._lanes.values():
                for req in list(lane):
                    req.error = req.error or message
                    self._finalize(req)
                lane.clear()

    def drain(self, abort_message: str = "sweep service closed") -> None:
        """Graceful drain: fail requests that never reached a block
        (definite error, no hang), then flush every in-flight request —
        one that already has rows in completed blocks finishes its
        remaining rows before the service goes down."""
        with self._cv:
            for lane in self._lanes.values():
                for req in [r for r in lane if r.cursor == 0]:
                    req.error = req.error or abort_message
                    self._finalize(req)
                    lane.remove(req)
        while True:
            try:
                if not self.step():
                    break
            except Exception:
                # step() already failed the faulting block's requests;
                # draining continues with whatever is left
                continue

    def _pick_lane(self) -> Optional[str]:
        """Interactive first; one bulk block is forced through after
        ``starvation_limit`` consecutive interactive blocks."""
        for lane in (self._lanes[INTERACTIVE], self._lanes[BULK]):
            self._reap_cancelled(lane)
            self._reap_expired(lane)
            self._reap_quarantined(lane)
        has_i = bool(self._lanes[INTERACTIVE])
        has_b = bool(self._lanes[BULK])
        if not has_b:
            # starvation debt only accrues while bulk work actually
            # waits — a stale counter must not let a fresh bulk sweep
            # preempt the interactive lane
            self._consec_interactive = 0
        if has_i and has_b:
            if self._consec_interactive >= self.starvation_limit:
                return BULK
            return INTERACTIVE
        if has_i:
            return INTERACTIVE
        if has_b:
            return BULK
        return None

    def _assemble(self) -> Optional[_Block]:
        """Build the next block: anchor on the chosen lane's oldest live
        request, fill with same-design rows from every queued request."""
        with self._cv:
            lane_name = self._pick_lane()
            if lane_name is None:
                return None
            lane = self._lanes[lane_name]
            anchor = lane[0]
            items: List[Tuple[_Request, int]] = []
            for scan in (lane_name, BULK if lane_name == INTERACTIVE
                         else INTERACTIVE):
                q = self._lanes[scan]
                for req in list(q):
                    if len(items) >= self.block:
                        break
                    if req.cancelled.is_set():
                        continue         # reaped at the front eventually
                    if req.entry is not anchor.entry:
                        continue
                    take = min(self.block - len(items), req.K - req.cursor)
                    if req.cursor == 0 and take:
                        obs.emit("sweep.queued", req.t_submit * 1e9,
                                 _time.perf_counter_ns(), lane=req.priority)
                    items.extend((req, i) for i in
                                 range(req.cursor, req.cursor + take))
                    req.cursor += take
                    if req.cursor >= req.K:
                        q.remove(req)
            if lane_name == INTERACTIVE:
                # starvation debt accrues only while bulk work waits
                self._consec_interactive = (self._consec_interactive + 1
                                            if self._lanes[BULK] else 0)
                self.stats_blocks_interactive += 1
            else:
                self._consec_interactive = 0
                self.stats_blocks_bulk += 1
            self.stats_blocks += 1
            self.stats_rows += len(items)
            return _Block(anchor.entry, items, lane_name)

    # -------------------------------------------------------------- solve
    def _launch(self, entry: CacheEntry, Db: np.ndarray,
                pooled: bool) -> _Attempt:
        """Start one shard attempt; injector sites are drawn HERE, on the
        scheduler thread, so fault patterns are deterministic in manual
        mode regardless of worker timing."""
        inj = self.injector
        hang_s = (inj.hang_s if inj is not None
                  and inj.draw(SHARD_HANG, key=entry.key) else 0.0)
        boom = bool(inj is not None and inj.draw(SHARD_FAULT,
                                                 key=entry.key))
        corrupt = bool(inj is not None and inj.draw(SHARD_CORRUPT,
                                                    key=entry.key))
        if not pooled:
            call = (lambda: _shard_task(entry.graph, Db, self.backend,
                                        self.block, hang_s, boom, corrupt,
                                        self.device))
            return _Attempt(None, call, self._pool_gen)
        if self.mode == "process":
            self._register_blob(entry)
            fut = self._submit(_process_shard_solve, entry.key, None,
                               Db, self.backend, self.block,
                               hang_s, boom, corrupt, self.device)
        else:
            fut = self._submit(_shard_task, entry.graph, Db,
                               self.backend, self.block,
                               hang_s, boom, corrupt, self.device)
        return _Attempt(fut, None, self._pool_gen)

    def _collect(self, entry: CacheEntry, Db: np.ndarray,
                 attempt: _Attempt, pooled: bool,
                 t_deadline: Optional[float]):
        """Wait for one shard chunk, retrying per the RetryPolicy within
        the deadline budget.  Returns ``(status, cycles, violated, note)``
        for the chunk — on exhaustion the rows carry FAULTED/TIMED_OUT
        and ``note`` holds the human-readable cause."""
        K = len(Db)
        inj = self.injector

        def fail(code: int, note: str):
            if code == FAULTED:
                tripped = self.quarantine.strike(entry.key, note)
                if tripped:
                    note += " (design quarantined)"
                with self._cv:
                    self.stats_faulted_rows += K
            else:
                with self._cv:
                    self.stats_timed_out_rows += K
            return (np.full(K, code, np.int8), np.full(K, -1, np.int64),
                    np.zeros(K, np.int64), note)

        tries = 0
        while True:
            if t_deadline is not None:
                remaining = t_deadline - _time.perf_counter()
                if remaining <= 0:
                    return fail(TIMED_OUT,
                                "deadline exceeded while solving this "
                                "shard")
            else:
                remaining = None
            kind, note = "fault", ""
            eff = self.shard_timeout_s
            try:
                if inj is not None and inj.draw(POOL_BROKEN,
                                                key=entry.key):
                    raise _PoolBrokenFault(POOL_BROKEN, -1)
                if attempt.fut is not None:
                    if remaining is not None:
                        eff = (min(eff, remaining) if eff is not None
                               else remaining)
                    out = attempt.fut.result(timeout=eff)
                else:
                    out = attempt.call()
                if isinstance(out, str) and out == _NEED_BLOB:
                    # worker spawned after this design appeared: reship
                    # the blob once for this chunk (not a retry)
                    with self._cv:
                        self.stats_blob_reships += 1
                    fut = self._submit(
                        _process_shard_solve, entry.key,
                        self._register_blob(entry), Db, self.backend,
                        self.block, 0.0, False, False, self.device)
                    attempt = _Attempt(fut, None, self._pool_gen)
                    continue
                status, cycles, violated, _rounds = out
                if (len(status) != K or len(cycles) != K
                        or len(violated) != K):
                    raise ShardCorruption(
                        f"shard returned {len(status)} rows for a "
                        f"{K}-row chunk")
                return (np.asarray(status, np.int8),
                        np.asarray(cycles, np.int64),
                        np.asarray(violated, np.int64), "")
            except (_FutTimeout, TimeoutError):
                kind = "timeout"
                note = (f"shard timed out after "
                        f"{eff if eff is not None else 0:.3g}s")
            except (BrokenExecutor, _PoolBrokenFault) as exc:
                # every chunk whose future died with the pool lands here;
                # only the first one pays a respawn — later ones see the
                # new generation and simply relaunch on it
                if attempt.gen == self._pool_gen:
                    with self._cv:
                        ok = self._respawn_pool()
                    if not ok:
                        return fail(FAULTED,
                                    f"worker pool broke ({exc!r}) and the "
                                    f"respawn budget is spent")
                attempt = self._launch(entry, Db, pooled)
                continue               # a respawn is not a solve retry
            except CancelledError:
                # queued task cancelled by a pool respawn: relaunch
                attempt = self._launch(entry, Db, pooled)
                continue
            except Exception as exc:
                kind = "fault"
                note = f"shard solve faulted: {exc!r}"
            tries += 1
            if tries >= self.retry.max_attempts:
                note += f" (after {tries} attempts)"
                return fail(FAULTED if kind == "fault" else TIMED_OUT,
                            note)
            backoff = self.retry.backoff(tries - 1)
            if t_deadline is not None:
                backoff = min(backoff,
                              max(t_deadline - _time.perf_counter(), 0.0))
            if backoff > 0:
                _time.sleep(backoff)
            with self._cv:
                self.stats_retries += 1
            attempt = self._launch(entry, Db, pooled)

    def _solve_unique(self, entry: CacheEntry, Du: np.ndarray,
                      t_deadline: Optional[float] = None):
        """Solve the unique rows of a block, sharded across workers.

        Returns ``(status, cycles, violated, notes)`` where ``notes`` maps
        unique-row positions to fault detail strings for rows that ended
        FAULTED/TIMED_OUT instead of being solved.
        """
        U = len(Du)
        pooled = not (self._pool is None or U < self.min_shard_rows
                      or self.shards == 1)
        if pooled:
            idx_chunks = [c for c in
                          np.array_split(np.arange(U),
                                         min(self.shards, U)) if len(c)]
        else:
            idx_chunks = [np.arange(U)]
        status = np.empty(U, dtype=np.int8)
        cycles = np.full(U, -1, dtype=np.int64)
        violated = np.zeros(U, dtype=np.int64)
        notes: Dict[int, str] = {}
        attempts = [self._launch(entry, Du[c], pooled) for c in idx_chunks]
        for c, attempt in zip(idx_chunks, attempts):
            st, cy, vi, note = self._collect(entry, Du[c], attempt,
                                             pooled, t_deadline)
            status[c], cycles[c], violated[c] = st, cy, vi
            if note:
                for u in c:
                    notes[int(u)] = note
        return status, cycles, violated, notes

    # ------------------------------------------------------------ deliver
    def _deliver(self, blk: _Block) -> None:
        entry = blk.entry
        rows = np.stack([req.D[i] for (req, i) in blk.items])
        Du, inverse = np.unique(rows, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        with self._cv:
            self.stats_rows_unique += len(Du)
        deadlines = [req.t_deadline for (req, _i) in blk.items
                     if req.t_deadline is not None]
        t_deadline = min(deadlines) if deadlines else None
        # cross-block memo: identical (design, depth-row) pairs seen in any
        # earlier block are answered without a solver call — only the
        # residual rows reach _solve_unique
        U = len(Du)
        status_u = np.empty(U, dtype=np.int8)
        cycles_u = np.full(U, -1, dtype=np.int64)
        violated_u = np.zeros(U, dtype=np.int64)
        notes: Dict[int, str] = {}
        memo_hit = np.zeros(U, dtype=bool)
        if self.memo_capacity:
            with self._cv:
                for u in range(U):
                    mk = (entry.key, Du[u].tobytes())
                    got = self._memo.get(mk)
                    if got is not None:
                        self._memo.move_to_end(mk)
                        status_u[u], cycles_u[u], violated_u[u] = got
                        memo_hit[u] = True
                        self.stats_memo_hits += 1
        solve_idx = np.flatnonzero(~memo_hit)
        if len(solve_idx):
            st, cy, vi, sub_notes = self._solve_unique(
                entry, Du[solve_idx], t_deadline)
            status_u[solve_idx] = st
            cycles_u[solve_idx] = cy
            violated_u[solve_idx] = vi
            for su, note in sub_notes.items():
                notes[int(solve_idx[su])] = note
            if self.memo_capacity:
                with self._cv:
                    for su in range(len(solve_idx)):
                        s = int(st[su])
                        if s == FAULTED or s == TIMED_OUT:
                            continue
                        self._memo[(entry.key,
                                    Du[solve_idx[su]].tobytes())] = (
                            s, int(cy[su]), int(vi[su]))
                    while len(self._memo) > self.memo_capacity:
                        self._memo.popitem(last=False)

        # a failed unique row pays for its exact fallback only if a LIVE
        # request owning it asked for fallback (a cancelled or expired
        # tenant's rows must not cost engine re-simulations nobody will
        # receive)
        now = _time.perf_counter()
        fb_mask = np.zeros(len(Du), dtype=bool)
        for pos, (req, _i) in enumerate(blk.items):
            if (req.fallback and not req.cancelled.is_set()
                    and not req.expired(now)):
                fb_mask[inverse[pos]] = True
        # exact fallback needs the engine: once per unique row, under the
        # design's entry lock (depths are mutated + restored); the shared
        # dse helper keeps verdicts byte-identical to resimulate_batch's.
        # A faulting fallback (poisoned design) must not fail the block:
        # solver verdicts stand, only the engine-exact results are
        # withheld, and the design takes a quarantine strike.
        try:
            results_u, reasons_u = materialize_block(
                entry.result, Du, status_u, cycles_u, violated_u, fb_mask,
                engine_label="omnisim-sweep", lock=entry.lock,
                hybrid_cache=self.hybrid)
        except Exception as exc:
            note = f"fallback re-simulation faulted: {exc!r}"
            self.quarantine.strike(entry.key, note)
            results_u, reasons_u = materialize_block(
                entry.result, Du, status_u, cycles_u, violated_u,
                np.zeros(len(Du), dtype=bool),
                engine_label="omnisim-sweep", lock=entry.lock,
                hybrid_cache=self.hybrid)
            for u in range(len(Du)):
                if fb_mask[u] and status_u[u] != REUSED:
                    reasons_u[u] += f" [{note}]"
            fb_mask[:] = False
        for u, note in notes.items():
            reasons_u[u] = note
        n_fb = int((fb_mask & (status_u != REUSED)).sum())
        if n_fb:
            with self._cv:
                self.stats_fallbacks += n_fb

        now = _time.perf_counter()
        for pos, (req, i) in enumerate(blk.items):
            if req.cancelled.is_set():
                continue
            if req.expired(now):
                # end-to-end deadline: a result that arrives late is a
                # timeout, not a delivery
                req.out_q.put(ConfigResult(
                    request_id=req.rid, index=i,
                    depths=tuple(int(d) for d in req.D[i]),
                    ok=False, status=TIMED_OUT, cycles=-1, violated=0,
                    reason="deadline exceeded before this config was "
                           "delivered", result=None))
                with self._cv:
                    self.stats_timed_out_rows += 1
            else:
                u = int(inverse[pos])
                use_fb = req.fallback or status_u[u] == REUSED
                req.out_q.put(ConfigResult(
                    request_id=req.rid, index=i,
                    depths=tuple(int(d) for d in req.D[i]),
                    ok=bool(status_u[u] == REUSED),
                    status=int(status_u[u]),
                    cycles=int(cycles_u[u]) if use_fb else -1,
                    violated=int(violated_u[u]), reason=reasons_u[u],
                    result=results_u[u] if use_fb else None))
            req.delivered += 1
            if req.delivered >= req.K:
                self._finish(req)
        for req, _i in blk.items:
            if req.cancelled.is_set():
                self._finalize(req)

    # --------------------------------------------------------------- step
    def step(self) -> bool:
        """Assemble, solve and deliver ONE block; False when idle.

        The public unit of progress: the service's background thread calls
        it in a loop, and deterministic tests drive it directly.  Shard
        faults and timeouts are absorbed inside the block (FAULTED /
        TIMED_OUT rows); only a genuine scheduler bug reaches the except
        path, which fails exactly the block's requests (error + terminal
        sentinel, so no client stream hangs) and re-raises.
        """
        t0 = _time.perf_counter_ns()
        blk = self._assemble()
        if blk is None:
            return False
        try:
            self._deliver(blk)
        except Exception as exc:
            msg = f"sweep block failed: {exc!r}"
            self.quarantine.strike(blk.entry.key, msg)
            with self._cv:
                for req, _i in blk.items:
                    req.error = req.error or msg
                    self._finalize(req)
                    for lane in self._lanes.values():
                        if req in lane:          # rows beyond this block
                            lane.remove(req)
            raise
        obs.emit("sweep.block", t0, _time.perf_counter_ns())
        return True

    def wait_for_work(self, timeout: float = 0.2) -> None:
        with self._cv:
            if self._pick_lane() is None:
                self._cv.wait(timeout)

    def has_work(self) -> bool:
        with self._cv:
            return self._pick_lane() is not None

    def stats(self) -> Dict[str, float]:
        with self._cv:
            solved = max(self.stats_rows_unique, 1)
            return {
                "requests": self.stats_requests,
                "blocks": self.stats_blocks,
                "blocks_interactive": self.stats_blocks_interactive,
                "blocks_bulk": self.stats_blocks_bulk,
                "rows": self.stats_rows,
                "rows_unique": self.stats_rows_unique,
                "dedup_ratio": (self.stats_rows / solved
                                if self.stats_rows else 1.0),
                "fallbacks": self.stats_fallbacks,
                "cancelled_rows": self.stats_cancelled_rows,
                "retries": self.stats_retries,
                "faulted_rows": self.stats_faulted_rows,
                "timed_out_rows": self.stats_timed_out_rows,
                "pool_respawns": self.stats_pool_respawns,
                "blob_reships": self.stats_blob_reships,
                "memo_hits": self.stats_memo_hits,
                "memo_size": len(self._memo),
                "shards": self.shards,
                "mode": self.mode,
            }

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
