"""Served edit sessions: the interactive edit-compile-sim loop.

An :class:`EditSession` is the front door the sweep service hands out via
``SweepService.edit_session(design)``.  It pins the design's current cache
entry and delta state; each ``update(new_program)`` classifies the edit
(``repro_torch.delta.fingerprint``), asks the warm cache for the best reuse tier
(exact-key hit → per-module patch → cold rebuild, ``sweep/cache.py``) and
repoints the session at the resulting entry.  Subsequent ``submit`` /
``sweep`` calls serve depth sweeps of the *edited* design from the patched
graph — no re-record of the untouched modules, no service restart.

Patched entries are inserted under the edited design's own fingerprint as
*new* cache entries, never by mutating the old one in place: the scheduler
coalesces queued rows by entry identity, so rows submitted before an edit
keep solving against the graph they were submitted for.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..core.dse import program_mutation_lock
from ..core.program import Program
from .fingerprint import DesignDelta, DesignFingerprint, diff, \
    fingerprint_design

__all__ = ["EditOutcome", "EditSession"]


@dataclass
class EditOutcome:
    """What one ``EditSession.update`` call did."""

    mode: str                       # "unchanged" | "exact" | "patched" | "cold"
    delta: Optional[DesignDelta]    # vs the session's previous program
    reused_modules: int
    total_modules: int
    elapsed_s: float
    reason: str = ""                # reject/why-cold detail (may be empty)
    key: str = ""                   # the now-active cache key

    @property
    def reuse_fraction(self) -> float:
        return self.reused_modules / max(self.total_modules, 1)


class EditSession:
    """Handle for one tenant's edit-and-resimulate loop.

    Created by ``SweepService.edit_session``; holds the service, the
    current program + fingerprint table, the active ``CacheEntry`` and the
    reusable :class:`~repro_torch.delta.patch.DeltaState` (``None`` for dynamic
    designs — those always rebuild cold, but still get exact-key reuse).
    """

    def __init__(self, service, program: Program, key: Optional[str] = None):
        self._service = service
        self._cache = service.cache
        self.program = program
        with program_mutation_lock(program):
            self.fps: DesignFingerprint = fingerprint_design(program)
        if key is not None and key != self.fps.key:
            raise ValueError("key does not match the design fingerprint")
        self.key = self.fps.key
        look = self._cache.get_or_patch(program, self.fps, None)
        self.entry = look.entry
        self.state = look.state
        self.updates = 0
        self.counts: Dict[str, int] = {"unchanged": 0, "exact": 0,
                                       "patched": 0, "cold": 0,
                                       "rejected": 0}

    # ------------------------------------------------------------------
    def update(self, new_program: Program) -> EditOutcome:
        """Swap the session to an edited design, reusing what the delta
        allows.  Always succeeds — the worst case is a cold rebuild."""
        t0 = _time.perf_counter()
        with program_mutation_lock(new_program):
            new_fps = fingerprint_design(new_program)
        delta = diff(self.fps, new_fps)
        total = len(new_fps.modules)
        if new_fps.key == self.key:
            mode, reason = "unchanged", ""
            reused = total
        else:
            # hand the classification down iff it is the one the cache
            # would compute (vs the *state's* fingerprint — after an
            # exact-tier hit the session fps can be ahead of the state)
            d = delta if (self.state is not None
                          and self.state.fps is self.fps) else None
            look = self._cache.get_or_patch(new_program, new_fps,
                                            self.state, delta=d)
            mode, reason = look.mode, look.reason
            self.entry = look.entry
            if look.state is not None:
                self.state = look.state
            elif mode == "cold":
                self.state = None          # dynamic design: no delta state
            reused = look.reused_modules if mode == "patched" else (
                total if mode == "exact" else 0)
            if reason and mode == "cold":
                self.counts["rejected"] += 1
        self.program = new_program
        self.fps = new_fps
        self.key = new_fps.key
        self.updates += 1
        self.counts[mode] += 1
        return EditOutcome(mode=mode, delta=delta, reused_modules=reused,
                           total_modules=total,
                           elapsed_s=_time.perf_counter() - t0,
                           reason=reason, key=self.key)

    # ------------------------------------------------------------------
    # serving passthroughs: sweeps of the *current* program
    def submit(self, depth_blocks, **kw):
        return self._service.submit(self.program, depth_blocks, **kw)

    def sweep(self, depth_blocks, **kw):
        return self._service.sweep(self.program, depth_blocks, **kw)

    def result(self) -> "Program":
        return self.program

    def stats(self) -> Dict[str, object]:
        return {"updates": self.updates, "key": self.key,
                "patchable": self.state is not None, **self.counts}
