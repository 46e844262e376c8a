"""Warm compiled-graph cache: the state that makes served DSE fast.

PyTorch port of ``repro.sweep.cache``.  A sweep request against a design
the service has seen before should pay for *nothing* but the per-config
fixpoint: no initial simulation, no graph compilation, no ``_BatchArrays``
hoisting, no no-WAR seed solve.  :class:`GraphCache` holds exactly that
warm state — a bounded LRU mapping content-addressed design keys
(:func:`repro_torch.core.program_fingerprint`) to :class:`CacheEntry`
triples ``(SimResult, CompiledGraph, _BatchArrays)``:

  * ``result`` — the base simulation;
  * ``graph``  — the :class:`~repro_torch.core.incremental.CompiledGraph`
    hoisted from it;
  * ``batch``  — the chain-major ``_BatchArrays`` view with its no-WAR
    seed fixpoint, the per-(FIFO, depth) WAR column cache and the device
    copies of the solver's arrays, which keep *warming themselves* as more
    depth vectors are served (built lazily on first solve).

Keys deliberately exclude nothing the closure captures: two Programs built
by the same design function with the same arguments share an entry;
changing any argument (or the module bytecode) misses.  The
incremental-resimulation contract serves *any* candidate depth vector
from a base run, so one entry answers a design's whole sweep space.

The cache owns a shared :class:`~repro_torch.core.trace.HybridCache`: a
cold build of a dynamic (NB/probe) design threads it into ``simulate``, and
the verified whole-run replay entry that build produced spills onto the
:class:`CacheEntry` (``full_run``) and is reinstalled on every hit.  The
delta-aware lookup :meth:`GraphCache.get_or_patch` (exact key, then a
per-module patch, then a cold build; ``repro_torch.delta``) serves edit
sessions.

Thread safety: lookups/inserts are lock-protected, and the whole
fingerprint-and-build path serializes per design on
``core.dse.program_mutation_lock`` — the same lock the fallback
re-simulation holds while it transiently mutates that Program's FIFO
depths — so a build never observes (or races) another thread's in-place
depth mutation, a concurrent double miss builds once, and unrelated
designs proceed concurrently.  Hits, misses and evictions are counted and
exposed via :meth:`GraphCache.stats`.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
import time as _time
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Union

from ..core.dse import _batch_arrays, program_mutation_lock
from ..core.engine import simulate
from ..core.incremental import CompiledGraph, compile_graph
from ..core.program import Program, SimResult
from ..core.trace import HybridCache, program_fingerprint
from ..delta.fingerprint import DesignDelta, DesignFingerprint, diff
from ..delta.patch import DeltaState, apply_patch, cold_build


class CacheEntry:
    """One warm design: base run + hoisted graph + batch view.

    ``full_run`` holds the hybrid whole-run replay entry (``_FullRun``)
    the cold build left in the shared ``HybridCache``, if it made one."""

    __slots__ = ("key", "result", "graph", "_batch", "hits", "build_s",
                 "lock", "_graph_blob", "full_run")

    def __init__(self, key: str, result: SimResult, graph: CompiledGraph,
                 batch=None, build_s: float = 0.0):
        self.key = key
        self.result = result
        self.graph = graph
        self._batch = batch
        self.hits = 0
        self.build_s = build_s
        # serializes engine-touching work (fallback re-simulation mutates
        # Program FIFO depths in place and restores them)
        self.lock = threading.Lock()
        self._graph_blob: Optional[bytes] = None
        self.full_run = None

    @property
    def batch(self):
        """Chain-major ``_BatchArrays`` view, built on first use (it
        includes the no-WAR seed fixpoint — the most expensive part of
        warming a design); the first sweep solve against the entry builds
        it via the same ``_batch_arrays`` memo the shard solvers use."""
        if self._batch is None:
            self._batch = _batch_arrays(self.graph)
        return self._batch

    @property
    def program(self) -> Program:
        return self.result.graph.program

    @property
    def n_fifos(self) -> int:
        return len(self.program.fifos)

    def graph_blob(self) -> bytes:
        """Pickled CompiledGraph for process-shard workers (cached).

        Serialized *without* the ``batch`` view: workers rebuild it once
        from the arrays (cheap) and then keep their own warm copy — and
        their own device copies of its arrays, since no device tensor
        crosses the pipe.  The scheduler hands this blob to process-pool
        *initializers* (and to need-blob reship round trips), so
        steady-state tasks, retries and pool respawns ship only the design
        key — never the serialized graph.
        """
        if self._graph_blob is None:
            # pickle a shallow copy with the batch view stripped: the graph
            # is shared with concurrent thread-shard solvers, so it must
            # never be mutated here, not even transiently; the copy shares
            # every (immutable) array
            clone = dataclasses.replace(self.graph, batch=None)
            self._graph_blob = pickle.dumps(clone, pickle.HIGHEST_PROTOCOL)
        return self._graph_blob


class DeltaLookup(NamedTuple):
    """Result of the delta-aware lookup tiers (:meth:`GraphCache.get_or_patch`).

    ``mode`` is the reuse tier that answered: ``"exact"`` (whole-key hit),
    ``"patched"`` (per-module partial hit) or ``"cold"`` (miss / rejected
    patch).  ``state`` is the refreshed delta snapshot when one exists.
    """

    entry: CacheEntry
    mode: str
    reason: str
    state: Optional[DeltaState]
    reused_modules: int
    total_modules: int


class GraphCache:
    """Bounded LRU of warm :class:`CacheEntry` objects, keyed by content.

    Owns a shared :class:`~repro_torch.core.trace.HybridCache`: cold builds
    of dynamic designs thread it into ``simulate`` so their verified
    ``_FullRun`` entries spill onto the cache entry and reinstall on every
    hit — served tenants warm each other's hybrid replays.
    """

    def __init__(self, capacity: int = 8,
                 hybrid: Optional[HybridCache] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hybrid = hybrid if hybrid is not None else HybridCache(
            max_full=max(8, 2 * capacity))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.delta_hits = 0
        self.delta_rejects = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: str) -> Optional[CacheEntry]:
        """LRU-touching lookup; counts a hit or a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            entry.hits += 1
            if entry.full_run is not None:
                # reinstall the spilled whole-run entry: a fallback re-sim
                # of this design at these depths replays instead of
                # re-interpreting (dict ops are GIL-atomic; peek/store
                # race at worst re-stores an identical verified entry)
                self.hybrid.store_full(key, entry.full_run)
            return entry

    def insert(self, entry: CacheEntry) -> CacheEntry:
        with self._lock:
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            return entry

    def get_or_build(self, design: Union[Program, SimResult],
                     key: Optional[str] = None,
                     simulate_fn: Callable = simulate) -> CacheEntry:
        """Return the warm entry for ``design``, building it on a miss.

        ``design`` is either a :class:`Program` (a miss runs the initial
        simulation through ``simulate_fn``) or an existing base
        :class:`SimResult` (a miss only hoists the compiled graph from
        it).  ``key`` overrides the content fingerprint for callers that
        already know their design identity.
        """
        base: Optional[SimResult] = None
        if isinstance(design, SimResult):
            base = design
            program = design.graph.program
        else:
            program = design
        # fingerprinting reads Program FIFO depths, and a miss simulates
        # the Program — both must not observe another thread's transient
        # fallback depth mutation of the same Program; inserting inside the
        # lock also makes a concurrent double miss build once
        with program_mutation_lock(program):
            if key is None:
                key = program_fingerprint(program)
            entry = self.lookup(key)
            if entry is not None:
                return entry
            t0 = _time.perf_counter()
            if base is None:
                if simulate_fn is simulate:
                    # default path: thread the shared HybridCache so a
                    # dynamic design's verified _FullRun lands in it
                    base = simulate(program, hybrid_cache=self.hybrid)
                else:
                    base = simulate_fn(program)
            return self.insert(self._entry_from(key, base, t0))

    def _entry_from(self, key: str, base: SimResult,
                    t0: float) -> CacheEntry:
        """Hoist the compiled graph from a base run and spill the hybrid
        whole-run entry (if the build produced one) onto the entry.  The
        batch view is built on first use (:attr:`CacheEntry.batch`)."""
        graph = compile_graph(base.graph)
        entry = CacheEntry(key, base, graph,
                           build_s=_time.perf_counter() - t0)
        entry.full_run = self.hybrid.peek_full(key)
        return entry

    def get_or_patch(self, program: Program, fps: DesignFingerprint,
                     state: Optional[DeltaState],
                     delta: Optional["DesignDelta"] = None) -> DeltaLookup:
        """Delta-aware lookup: exact-key hit → per-module patch → cold.

        The tiers, in order: (1) ``fps.key`` already cached (another
        tenant — or a previous edit — built this exact design): reuse it
        outright.  (2) ``state`` holds a recorded snapshot and the delta
        from it is patchable: re-record only the edited modules, splice,
        verify (``repro_torch.delta.patch``) — a verification reject falls
        through.  (3) cold rebuild (capturing a fresh snapshot for
        traceable designs).  ``delta_hits``/``delta_rejects`` count tier-2
        outcomes and surface in :meth:`stats`.

        ``delta`` optionally supplies the caller's already-classified
        ``diff(state.fps, fps)`` (the edit session computes one for its
        outcome report) so it isn't recomputed here.
        """
        total = len(fps.modules)
        with program_mutation_lock(program):
            entry = self.lookup(fps.key)
            if entry is not None:
                return DeltaLookup(entry, "exact", "", None, total, total)
            t0 = _time.perf_counter()
            reason = ""
            if state is not None:
                if delta is None:
                    delta = diff(state.fps, fps)
                if delta.patchable:
                    out = apply_patch(state, program, delta=delta,
                                      new_fps=fps)
                    if out.ok:
                        entry = self.insert(
                            self._entry_from(fps.key, out.result, t0))
                        with self._lock:
                            self.delta_hits += 1
                        return DeltaLookup(entry, "patched", "", out.state,
                                           out.reused_modules, total)
                    reason = out.reason
                else:
                    reason = delta.reason
                with self._lock:
                    self.delta_rejects += 1
            base, new_state = cold_build(program, hybrid_cache=self.hybrid,
                                         fps=fps)
            entry = self.insert(self._entry_from(fps.key, base, t0))
            return DeltaLookup(entry, "cold", reason, new_state, 0, total)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
                "delta_hits": self.delta_hits,
                "delta_rejects": self.delta_rejects,
                "full_runs": sum(1 for e in self._entries.values()
                                 if e.full_run is not None),
            }
