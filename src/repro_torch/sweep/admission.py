"""Admission control for the sweep service: quotas and load shedding.

PyTorch-port copy of ``repro.sweep.admission`` (host logic, unchanged).

A served system must refuse work it cannot absorb — *definitively*.  The
:class:`AdmissionController` sits in ``SweepService.submit`` and decides,
before a request touches the cache or the scheduler, whether to admit it:

  * **per-tenant in-flight row quotas** — one tenant's 10^6-row bulk
    sweep cannot monopolize the scheduler: each tenant may have at most
    ``max_inflight_rows_per_tenant`` rows admitted-but-unfinished at a
    time (reserved atomically at submit, released when the request's
    stream finishes for any reason — delivered, cancelled, faulted or
    timed out);
  * **queue-depth load shedding** — beyond ``max_queued_rows`` total
    in-flight rows the service is saturated and sheds load instead of
    queueing unboundedly.

A shed request never hangs and never raises from the scheduler: its
handle completes immediately with every row in the ``REJECTED`` status
(``repro_torch.core.dse.REJECTED``) and a reason string — the client sees a
definite verdict it can retry against, not a stuck stream.  Both limits
default to ``None`` (unlimited), which keeps the library-use fast path
allocation-free.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

DEFAULT_TENANT = "default"


class AdmissionController:
    """Atomic reserve/release of in-flight row budget per tenant."""

    def __init__(self,
                 max_inflight_rows_per_tenant: Optional[int] = None,
                 max_queued_rows: Optional[int] = None):
        self.max_inflight_rows_per_tenant = max_inflight_rows_per_tenant
        self.max_queued_rows = max_queued_rows
        self._inflight: Dict[str, int] = {}
        self._total = 0
        self._lock = threading.Lock()
        self.admitted_requests = 0
        self.admitted_rows = 0
        self.rejected_requests = 0
        self.rejected_rows = 0

    # ------------------------------------------------------------- decide
    def try_admit(self, tenant: str, rows: int) -> Optional[str]:
        """Reserve ``rows`` for ``tenant``; ``None`` on admission, else
        the rejection reason (nothing reserved)."""
        with self._lock:
            have = self._inflight.get(tenant, 0)
            cap = self.max_inflight_rows_per_tenant
            if cap is not None and have + rows > cap:
                self.rejected_requests += 1
                self.rejected_rows += rows
                return (f"tenant {tenant!r} quota exceeded: {have} rows "
                        f"in flight + {rows} requested > {cap} allowed")
            if (self.max_queued_rows is not None
                    and self._total + rows > self.max_queued_rows):
                self.rejected_requests += 1
                self.rejected_rows += rows
                return (f"service saturated: {self._total} rows queued "
                        f"+ {rows} requested > {self.max_queued_rows} "
                        f"allowed (load shed)")
            self._inflight[tenant] = have + rows
            self._total += rows
            self.admitted_requests += 1
            self.admitted_rows += rows
            return None

    def release(self, tenant: str, rows: int) -> None:
        """Return a finished (or failed-to-enqueue) reservation."""
        with self._lock:
            have = self._inflight.get(tenant, 0)
            left = max(have - rows, 0)
            if left:
                self._inflight[tenant] = left
            else:
                self._inflight.pop(tenant, None)
            self._total = max(self._total - rows, 0)

    # -------------------------------------------------------------- stats
    def inflight(self, tenant: str = DEFAULT_TENANT) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "inflight_rows": self._total,
                "tenants": dict(self._inflight),
                "admitted_requests": self.admitted_requests,
                "admitted_rows": self.admitted_rows,
                "rejected_requests": self.rejected_requests,
                "rejected_rows": self.rejected_rows,
                "max_inflight_rows_per_tenant":
                    self.max_inflight_rows_per_tenant,
                "max_queued_rows": self.max_queued_rows,
            }
