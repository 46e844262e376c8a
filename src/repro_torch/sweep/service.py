"""The sweep service front door: submit / stream / stats.

PyTorch port of ``repro.sweep.service``.  Where the reference defaults to
the host solver, :class:`SweepService` defaults to the card
(``backend="cuda", device="cuda"``: the sparse max-plus CUDA kernel) and
raises at construction when there is no card or the kernel library does
not build; callers without a card pass ``device="cpu"`` (the kernels'
plain PyTorch versions) or a host backend (``"numpy"``).

:class:`SweepService` ties the warm cache (``cache.py``) to the
continuous-batching scheduler (``scheduler.py``) behind a three-call API:

    with SweepService() as svc:                      # on the card
        handle = svc.submit(program, depths=D)       # non-blocking
        for cfg in handle.stream():                  # per-config results
            ...
        outcome = handle.result()                    # BatchOutcome view

``submit`` resolves the design against the warm cache on the *caller's*
thread (a cold miss pays the one-off initial simulation + graph hoisting
there, keeping the scheduler loop hot for everyone else), then enqueues
the depth matrix.  Requests with at most ``interactive_max`` rows ride
the interactive priority lane; big sweeps go bulk.  ``sweep()`` is the
blocking convenience wrapper, ``stream()`` the one-shot iterator.

Fault tolerance: ``submit`` takes a ``tenant`` and an optional
``deadline_s`` — the deadline is enforced end-to-end by the scheduler
(undelivered rows of an expired request terminate ``TIMED_OUT``, never
hang).  Before a request touches the cache, the service checks the
design's :class:`~repro_torch.sweep.faults.DesignQuarantine` (a poisoned
design is refused fast) and the
:class:`~repro_torch.sweep.admission.AdmissionController`
(per-tenant in-flight row quotas + queue-depth load shedding); a refused
request returns a handle whose every row is ``REJECTED`` with a reason —
a definite verdict, not an exception and not a stuck stream.  Admission
reservations are released when the request's stream finishes for *any*
reason (delivered, cancelled, faulted, timed out).  ``close(drain=True)``
flushes in-flight sweeps before shutting down and fails never-scheduled
ones loudly.

Every verdict that IS delivered is exactly what a direct
``resimulate_batch`` — and therefore a from-scratch ``simulate`` — would
report for that depth vector; ``tests/test_torch_sweep.py`` holds the
served rows against the reference service's bit for bit across block
splits, shard counts, arrival orders, cache states and injected faults.
"""
from __future__ import annotations

import queue
import threading
import time as _time
from typing import Dict, Iterator, Optional, Union

import numpy as np

from ..core.dse import (CANCELLED, REJECTED, BatchOutcome,
                        program_mutation_lock)
from ..core.program import Program, SimResult
from ..core.trace import program_fingerprint
from .admission import DEFAULT_TENANT, AdmissionController
from .cache import DELTA_NOT_PORTED, GraphCache
from .faults import DesignQuarantine, FaultInjector, RetryPolicy
from .scheduler import (BULK, INTERACTIVE, _DONE, BlockScheduler,
                        ConfigResult, _Request)


class SweepTimeoutError(TimeoutError):
    """``SweepHandle.stream/result(timeout=...)`` saw no result within
    ``timeout`` seconds.  The handle stays live: call ``stream()`` or
    ``result()`` again to keep consuming from where it stopped."""

    def __init__(self, request_id: int, delivered: int, total: int,
                 timeout: float):
        super().__init__(
            f"sweep request {request_id}: no result within {timeout:.6g}s "
            f"({delivered}/{total} configs delivered so far; the handle "
            f"is still live — call stream()/result() again to resume)")
        self.request_id = request_id
        self.delivered = delivered
        self.total = total
        self.timeout = timeout


class SweepHandle:
    """Client-side view of one submitted sweep (single consumer)."""

    def __init__(self, request: _Request, scheduler: BlockScheduler):
        self._req = request
        self._sched = scheduler
        self._collected: Dict[int, ConfigResult] = {}
        self._closed = False
        self._lock = threading.Lock()

    @property
    def request_id(self) -> int:
        return self._req.rid

    @property
    def n_configs(self) -> int:
        return self._req.K

    @property
    def done(self) -> bool:
        return self._closed

    @property
    def cancelled(self) -> bool:
        return self._req.cancelled.is_set()

    @property
    def rejected(self) -> bool:
        """True when admission control or quarantine refused this sweep
        (every row reports ``REJECTED`` with the reason)."""
        return self._req.reject_reason is not None

    @property
    def tenant(self) -> str:
        return self._req.tenant

    def cancel(self) -> None:
        """Stop scheduling this sweep at the next block boundary.

        Results already streamed stay valid; rows never solved surface as
        ``CANCELLED`` entries in :meth:`result`.
        """
        self._req.cancelled.set()
        self._sched.kick()

    def stream(self, timeout: Optional[float] = None
               ) -> Iterator[ConfigResult]:
        """Yield per-config results as blocks complete (completion order;
        each :class:`ConfigResult` carries its row ``index``).  Ends when
        every row was delivered or the request was cancelled; raises
        ``RuntimeError`` if the scheduler aborted the request (fault or
        service shutdown), and :class:`SweepTimeoutError` if ``timeout``
        seconds pass without a result (the handle stays resumable)."""
        while not self._closed:
            try:
                item = self._req.out_q.get(timeout=timeout)
            except queue.Empty:
                raise SweepTimeoutError(
                    self._req.rid, len(self._collected), self._req.K,
                    timeout if timeout is not None else 0.0) from None
            if item is _DONE:
                self._closed = True
                break
            self._collected[item.index] = item
            yield item
        if self._req.error:        # also on re-entry after a fault
            raise RuntimeError(self._req.error)

    def result(self, timeout: Optional[float] = None) -> BatchOutcome:
        """Drain the stream and assemble a :class:`BatchOutcome` indexed
        like the submitted depth matrix (blocking)."""
        for _ in self.stream(timeout=timeout):
            pass
        K = self._req.K
        ok = np.zeros(K, dtype=bool)
        cycles = np.full(K, -1, dtype=np.int64)
        violated = np.zeros(K, dtype=np.int64)
        if self._req.reject_reason is not None:
            status = np.full(K, REJECTED, dtype=np.int8)
            reasons = [self._req.reject_reason] * K
        else:
            status = np.full(K, CANCELLED, dtype=np.int8)
            reasons = ["request cancelled before this config was "
                       "scheduled"] * K
        results = [None] * K
        for i, cfg in self._collected.items():
            ok[i] = cfg.ok
            cycles[i] = cfg.cycles
            status[i] = cfg.status
            violated[i] = cfg.violated
            reasons[i] = cfg.reason
            results[i] = cfg.result
        uniq = (len(np.unique(self._req.D, axis=0))
                if K > 1 else K)
        return BatchOutcome(ok=ok, cycles=cycles, status=status,
                            violated=violated, reasons=reasons,
                            results=results,
                            elapsed_s=_time.perf_counter()
                            - self._req.t_submit, n_unique=uniq)


class SweepService:
    """Served design-space exploration over a warm compiled-graph cache."""

    def __init__(self, cache_capacity: int = 8, block: int = 128,
                 shards: int = 1, mode: str = "thread",
                 interactive_max: int = 16, starvation_limit: int = 4,
                 backend: str = "cuda", autostart: bool = True,
                 min_shard_rows: int = 8,
                 retry: Optional[RetryPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 shard_timeout_s: Optional[float] = 30.0,
                 quarantine_after: int = 3,
                 quarantine_cooldown_s: Optional[float] = None,
                 max_pool_respawns: int = 2,
                 max_inflight_rows_per_tenant: Optional[int] = None,
                 max_queued_rows: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 device="cuda",
                 memo_capacity: int = 4096):
        quarantine = DesignQuarantine(threshold=quarantine_after,
                                      cooldown_s=quarantine_cooldown_s)
        # first: it raises when the device lane cannot run
        self.scheduler = BlockScheduler(block=block, shards=shards,
                                        mode=mode,
                                        starvation_limit=starvation_limit,
                                        backend=backend,
                                        min_shard_rows=min_shard_rows,
                                        retry=retry, injector=injector,
                                        shard_timeout_s=shard_timeout_s,
                                        quarantine=quarantine,
                                        max_pool_respawns=max_pool_respawns,
                                        device=device,
                                        memo_capacity=memo_capacity)
        self.cache = GraphCache(capacity=cache_capacity)
        self.scheduler.hybrid = self.cache.hybrid
        self.admission = AdmissionController(
            max_inflight_rows_per_tenant=max_inflight_rows_per_tenant,
            max_queued_rows=max_queued_rows)
        self.quarantine = quarantine
        self.interactive_max = interactive_max
        self.default_deadline_s = default_deadline_s
        self._autostart = autostart
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ runtime
    def _loop(self) -> None:
        consec_faults = 0
        while not self._stop.is_set():
            try:
                progressed = self.scheduler.step()
                consec_faults = 0
            except Exception as exc:        # noqa: BLE001 — must not die
                # step() already failed exactly the faulting block's
                # requests (error + terminal sentinel) — other tenants'
                # queued sweeps keep being served.  Only a *persistently*
                # faulting scheduler (e.g. a broken assemble path that
                # fails before any block exists) aborts everything rather
                # than spinning hot forever.
                consec_faults += 1
                if consec_faults >= 5:
                    self.scheduler.abort_pending(
                        f"sweep scheduler failing persistently: {exc!r}")
                    consec_faults = 0
                continue
            if not progressed:
                self.scheduler.wait_for_work(timeout=0.05)

    def _ensure_thread(self) -> None:
        if not self._autostart or (self._thread and self._thread.is_alive()):
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="sweep-scheduler", daemon=True)
        self._thread.start()

    def step(self) -> bool:
        """Manual-mode progress (``autostart=False``): run one scheduler
        block on the calling thread.  Deterministic tests drive this."""
        return self.scheduler.step()

    def close(self, drain: bool = True) -> None:
        """Shut the service down.

        ``drain=True`` (default) flushes gracefully: requests that already
        have rows in completed blocks finish their remaining rows; queued
        requests that never reached a block fail loudly (error + terminal
        sentinel).  ``drain=False`` aborts everything immediately.  Either
        way no client stream is left hanging.
        """
        self._stop.set()
        self.scheduler.kick()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if drain:
            self.scheduler.drain("sweep service closed")
        # anything still queued (drain=False, or a request the drain could
        # not flush) gets its terminal sentinel instead of leaving its
        # consumer blocked forever
        self.scheduler.abort_pending("sweep service closed")
        self.scheduler.close()

    def __enter__(self) -> "SweepService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- intake
    def warm(self, design: Union[Program, SimResult],
             key: Optional[str] = None):
        """Pre-populate the cache for ``design`` (cold-start off the
        request path); returns the warm entry."""
        return self.cache.get_or_build(design, key=key)

    def edit_session(self, design: Program, key: Optional[str] = None):
        """The reference's interactive edit-and-resimulate session; it
        needs the delta layer, which is not ported yet."""
        raise NotImplementedError(DELTA_NOT_PORTED)

    def _rejected_handle(self, D: np.ndarray, reason: str, tenant: str,
                         fallback: bool) -> SweepHandle:
        """A handle that never touches the scheduler: every row reports
        ``REJECTED`` with ``reason`` — definite, immediate, no hang."""
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        req = _Request(rid, None, D, INTERACTIVE, fallback, queue.Queue(),
                       tenant=tenant)
        req.reject_reason = reason
        req.finalized = True
        req.out_q.put(_DONE)
        return SweepHandle(req, self.scheduler)

    def submit(self, design: Union[Program, SimResult], depths,
               key: Optional[str] = None, priority: Optional[str] = None,
               fallback: bool = True, tenant: str = DEFAULT_TENANT,
               deadline_s: Optional[float] = None) -> SweepHandle:
        """Enqueue a sweep of ``depths`` (one row = one candidate depth
        vector) against ``design`` and return a :class:`SweepHandle`.

        ``design`` is a :class:`Program` or a finished base
        :class:`SimResult`; repeat designs (by content fingerprint or
        explicit ``key``) are served from the warm cache.  ``priority``
        defaults to ``"interactive"`` for at most ``interactive_max`` rows
        and ``"bulk"`` otherwise.  ``tenant`` names the client for
        admission-control quotas; ``deadline_s`` (default
        ``default_deadline_s``) bounds the request end-to-end — rows not
        delivered in time terminate ``TIMED_OUT``.  A request refused by
        quarantine or admission control returns a handle whose rows are
        all ``REJECTED`` (see :attr:`SweepHandle.rejected`).
        """
        if self._stop.is_set():
            raise RuntimeError("sweep service is closed")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        D = np.asarray(depths, dtype=np.int64)
        if D.ndim == 1:
            D = D[None, :]
        program = (design.graph.program if isinstance(design, SimResult)
                   else design)
        if key is None:
            with program_mutation_lock(program):
                key = program_fingerprint(program)
        # refuse before building: a quarantined design must not cost a
        # cache build, and a shed request must not evict a warm entry
        if self.quarantine.is_quarantined(key):
            why = self.quarantine.reason(key)
            return self._rejected_handle(
                D, "design quarantined after repeated solve faults"
                   f"{': ' + why if why else ''}", tenant, fallback)
        shed = self.admission.try_admit(tenant, len(D))
        if shed is not None:
            return self._rejected_handle(D, shed, tenant, fallback)
        try:
            entry = self.cache.get_or_build(design, key=key)
            if D.ndim != 2 or D.shape[1] != entry.n_fifos:
                raise ValueError(f"depth matrix {D.shape} does not match "
                                 f"{entry.n_fifos} FIFOs")
        except Exception as exc:
            self.admission.release(tenant, len(D))
            if not isinstance(exc, ValueError):
                self.quarantine.strike(key, f"cache build faulted: {exc!r}")
            raise
        if priority is None:
            priority = INTERACTIVE if len(D) <= self.interactive_max else BULK
        assert priority in (INTERACTIVE, BULK), priority
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        req = _Request(rid, entry, D, priority, fallback, queue.Queue(),
                       tenant=tenant, deadline_s=deadline_s,
                       on_finalize=lambda r:
                           self.admission.release(r.tenant, r.K))
        handle = SweepHandle(req, self.scheduler)
        if req.K == 0:
            # an empty sweep completes immediately — it must never reach
            # the scheduler (a zero-row block would fault the loop)
            req.finalized = True
            req.out_q.put(_DONE)
            return handle
        self.scheduler.submit(req)
        self._ensure_thread()
        return handle

    def stream(self, design: Union[Program, SimResult], depths,
               **kw) -> Iterator[ConfigResult]:
        """Submit and iterate per-config results (one-shot convenience)."""
        return self.submit(design, depths, **kw).stream()

    def sweep(self, design: Union[Program, SimResult], depths,
              **kw) -> BatchOutcome:
        """Submit and block for the assembled :class:`BatchOutcome`."""
        handle = self.submit(design, depths, **kw)
        if not self._autostart:
            while self.scheduler.step():
                pass
        return handle.result()

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {"cache": self.cache.stats(),
               "scheduler": self.scheduler.stats(),
               "admission": self.admission.stats(),
               "quarantine": self.quarantine.stats()}
        if self.scheduler.injector is not None:
            out["faults"] = self.scheduler.injector.stats()
        return out
