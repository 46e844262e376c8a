"""Served design-space exploration: sharded, streaming FIFO-depth sweeps
from a warm compiled-graph cache (PyTorch port of ``repro.sweep``).

The subsystem that turns ``repro_torch.core.resimulate_batch`` — a
blocking, single-host library call — into a multi-tenant workload whose
shards are solved on the card by the sparse max-plus CUDA kernel:

  * :mod:`repro_torch.sweep.cache`     — content-addressed LRU of warm
    ``(SimResult, CompiledGraph, _BatchArrays)`` design entries;
  * :mod:`repro_torch.sweep.scheduler` — continuous batching: cross-tenant
    block coalescing, in-block dedup, worker sharding (threads, or
    ``spawn`` processes), per-config streaming, cancellation, priority
    lanes, per-shard retry/timeout, pool respawn, end-to-end deadlines;
  * :mod:`repro_torch.sweep.faults`    — deterministic fault injection
    (``FaultInjector``), ``RetryPolicy``, and the per-design
    ``DesignQuarantine`` circuit breaker;
  * :mod:`repro_torch.sweep.admission` — per-tenant quotas and load
    shedding (``AdmissionController``);
  * :mod:`repro_torch.sweep.service`   — the front door
    (``SweepService.submit/stream/sweep/stats``), on the card by default;
  * :mod:`repro_torch.sweep.search`    — grid / random /
    successive-halving searches producing (FIFO area, latency) Pareto
    frontiers.
"""
from ..core.dse import CANCELLED, FAULTED, REJECTED, TIMED_OUT
from .admission import DEFAULT_TENANT, AdmissionController
from .cache import CacheEntry, GraphCache
from .faults import (DesignQuarantine, FaultInjector, InjectedFault,
                     RetryPolicy)
from .scheduler import BULK, INTERACTIVE, BlockScheduler, ConfigResult
from .search import (SearchOutcome, grid_search, pareto_front,
                     random_search, successive_halving)
from .service import SweepHandle, SweepService, SweepTimeoutError

__all__ = [
    "AdmissionController", "BlockScheduler", "BULK", "CacheEntry",
    "CANCELLED", "ConfigResult", "DEFAULT_TENANT", "DesignQuarantine",
    "FAULTED", "FaultInjector", "GraphCache", "grid_search",
    "InjectedFault", "INTERACTIVE", "pareto_front", "random_search",
    "REJECTED", "RetryPolicy", "SearchOutcome", "successive_halving",
    "SweepHandle", "SweepService", "SweepTimeoutError", "TIMED_OUT",
]
