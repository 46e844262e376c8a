"""Fault machinery for the sweep service: deterministic injection,
bounded retry with backoff, and a per-design circuit breaker.

PyTorch-port copy of ``repro.sweep.faults`` (host logic, unchanged).

Production brings failures the happy path never sees: a shard worker
raises mid-solve, hangs past every deadline, the whole process pool dies,
or one *design* is poisoned (its solves or fallback re-simulations fault
every time) and would otherwise take the service down for every tenant
co-scheduled with it.  This module holds the three pieces the hardened
scheduler (``scheduler.py``) is built on:

  * :class:`FaultInjector` — deterministic, seedable fault injection at
    named sites in the scheduler/worker code (``shard.fault``,
    ``shard.hang``, ``shard.corrupt``, ``pool.broken``).  The test suite
    and the fault benchmark drive every recovery path through it — same
    seed, same plan ⇒ same faults, so recovery behavior is pinned by
    ordinary assertions instead of flaky sleeps.
  * :class:`RetryPolicy` — bounded attempts with exponential backoff,
    always clipped to the request's remaining deadline budget.
  * :class:`DesignQuarantine` — a circuit breaker keyed by
    ``program_fingerprint``: repeated solve faults for ONE design trip
    the breaker, after which that design's requests are rejected fast
    (and its queued rows failed with a definite status) while every
    other design keeps being served.  Reset manually or after an
    optional cooldown.

Nothing here touches verdict content: a fault path may *withhold* a row
(``FAULTED`` / ``TIMED_OUT``), never alter one — rows that are delivered
stay bit-identical to the generator engine (pinned against the
reference service by ``tests/test_torch_sweep.py``).
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Injection sites the scheduler consults.  Named here so tests/docs and
# the scheduler cannot drift on spelling.
SHARD_FAULT = "shard.fault"       # shard solve raises
SHARD_HANG = "shard.hang"         # shard solve sleeps past its timeout
SHARD_CORRUPT = "shard.corrupt"   # shard returns malformed result arrays
POOL_BROKEN = "pool.broken"       # worker pool reports itself broken
SITES = (SHARD_FAULT, SHARD_HANG, SHARD_CORRUPT, POOL_BROKEN)


class InjectedFault(RuntimeError):
    """Raised (or simulated) by an armed :class:`FaultInjector` site."""

    def __init__(self, site: str, occurrence: int):
        super().__init__(f"injected fault at {site!r} (occurrence "
                         f"#{occurrence})")
        self.site = site
        self.occurrence = occurrence


class _PoolBrokenFault(InjectedFault):
    """Injected stand-in for ``concurrent.futures.BrokenExecutor`` — the
    scheduler's respawn path treats it exactly like the real thing."""


class _Arm:
    __slots__ = ("at", "rate", "rng", "key")

    def __init__(self, at, rate, rng, key):
        self.at = at
        self.rate = rate
        self.rng = rng
        self.key = key


class FaultInjector:
    """Deterministic, seedable fault injection at named sites.

    Each site is *armed* with either an explicit occurrence plan
    (``at=[0, 3]`` — fire on the 0th and 3rd draw at that site) or a
    seeded Bernoulli ``rate``; optionally scoped to one design via
    ``key`` (the design's content fingerprint) so one tenant's poisoned
    design can fault while co-scheduled designs stay clean.  Every
    random stream is derived from ``(seed, site)``, so the firing
    pattern of one site never depends on how often other sites are
    drawn — runs are reproducible under any interleaving.

        inj = FaultInjector(seed=7, hang_s=0.1)
        inj.arm("shard.fault", at=[0])          # first shard solve faults
        inj.arm("shard.hang", rate=0.1)         # 10% of shards hang
        inj.arm("shard.fault", rate=1.0, key=poisoned_key)

    The scheduler calls :meth:`draw` once per shard attempt per site; a
    ``True`` return makes it run the corresponding fault action.  An
    unarmed injector (or ``injector=None``, the production default) costs
    one ``None`` check per block.
    """

    def __init__(self, seed: int = 0, hang_s: float = 0.25):
        self.seed = int(seed)
        self.hang_s = float(hang_s)
        self._arms: Dict[str, List[_Arm]] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.log: List[Tuple[str, int, Optional[str]]] = []

    def arm(self, site: str, at: Optional[Iterable[int]] = None,
            rate: float = 0.0, key: Optional[str] = None) -> "FaultInjector":
        """Arm ``site`` with an occurrence plan and/or a fault rate,
        optionally scoped to one design ``key``.  Returns ``self`` so
        arms chain."""
        assert site in SITES, f"unknown injection site {site!r}"
        rng = np.random.default_rng(
            abs(hash((self.seed, site, key))) % (1 << 63))
        with self._lock:
            self._arms.setdefault(site, []).append(
                _Arm(frozenset(int(i) for i in (at or ())), float(rate),
                     rng, key))
        return self

    def draw(self, site: str, key: Optional[str] = None) -> bool:
        """One deterministic decision: does ``site`` fault on this draw?

        Increments the site's occurrence counter whether or not any arm
        matches, so plans stay stable when arms are added or removed.
        """
        with self._lock:
            arms = self._arms.get(site)
            count = self._counts.get(site, 0)
            self._counts[site] = count + 1
            if not arms:
                return False
            fired = False
            for arm in arms:
                if arm.key is not None and arm.key != key:
                    continue
                if count in arm.at:
                    fired = True
                # the rate stream advances only for matching arms — a
                # per-(site, key) stream independent of other designs
                elif arm.rate and arm.rng.random() < arm.rate:
                    fired = True
            if fired:
                self.log.append((site, count, key))
            return fired

    def fire(self, site: str, key: Optional[str] = None) -> None:
        """Raise :class:`InjectedFault` if :meth:`draw` fires (the
        convenience form for raise-only sites)."""
        with self._lock:
            count = self._counts.get(site, 0)
        if self.draw(site, key=key):
            raise InjectedFault(site, count)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            fired: Dict[str, int] = {}
            for site, _cnt, _key in self.log:
                fired[site] = fired.get(site, 0) + 1
            return {"draws": dict(self._counts), "fired": fired}


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff under a deadline budget.

    ``max_attempts`` counts the first try: ``max_attempts=3`` is one
    attempt plus two retries.  ``backoff(i)`` is the sleep before the
    i-th retry (0-based), exponentially grown and capped; the scheduler
    additionally clips every backoff to the affected requests' remaining
    deadline budget, so retrying can never push a row past its deadline
    just to sleep.
    """

    max_attempts: int = 3
    backoff_s: float = 0.01
    backoff_mult: float = 2.0
    max_backoff_s: float = 0.25

    def backoff(self, retry_index: int) -> float:
        return min(self.backoff_s * (self.backoff_mult ** retry_index),
                   self.max_backoff_s)


class DesignQuarantine:
    """Circuit breaker keyed by design fingerprint.

    Every exhausted-retries solve fault (and every faulting fallback
    re-simulation or cache build) records a *strike* against the
    design's key; ``threshold`` strikes trip the breaker.  A tripped
    design's queued rows fail fast with ``FAULTED`` and new submissions
    are rejected by the service front door — co-scheduled tenants keep
    being served instead of burning the retry budget on a poisoned
    design over and over.  ``cooldown_s`` (optional) auto-resets a trip
    after that many seconds; :meth:`reset` clears one key or all.
    """

    def __init__(self, threshold: int = 3,
                 cooldown_s: Optional[float] = None):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = cooldown_s
        self._strikes: Dict[str, int] = {}
        self._tripped: Dict[str, Tuple[float, str]] = {}
        self._lock = threading.Lock()
        self.trips = 0

    def strike(self, key: str, reason: str = "") -> bool:
        """Record one solve fault against ``key``; True if this strike
        trips (or re-trips) the breaker."""
        with self._lock:
            n = self._strikes.get(key, 0) + 1
            self._strikes[key] = n
            if n >= self.threshold and key not in self._tripped:
                self._tripped[key] = (_time.perf_counter(), reason)
                self.trips += 1
                return True
            return False

    def is_quarantined(self, key: str) -> bool:
        with self._lock:
            hit = self._tripped.get(key)
            if hit is None:
                return False
            if (self.cooldown_s is not None
                    and _time.perf_counter() - hit[0] >= self.cooldown_s):
                # cooldown elapsed: give the design a fresh budget
                del self._tripped[key]
                self._strikes.pop(key, None)
                return False
            return True

    def reason(self, key: str) -> str:
        with self._lock:
            hit = self._tripped.get(key)
            return hit[1] if hit else ""

    def reset(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._strikes.clear()
                self._tripped.clear()
            else:
                self._strikes.pop(key, None)
                self._tripped.pop(key, None)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "strikes": int(sum(self._strikes.values())),
                "designs_struck": len(self._strikes),
                "quarantined": len(self._tripped),
                "trips": self.trips,
                "threshold": self.threshold,
            }
