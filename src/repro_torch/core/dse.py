"""Depth-batched design-space exploration: K re-simulations in one pass.

PyTorch port of ``repro.core.dse``.  The paper's Table 6 capability —
re-evaluating a finished run under new FIFO depths in microseconds —
turned into a *throughput* engine: ``resimulate_batch`` treats K candidate
depth vectors as a leading batch axis over the whole incremental pipeline
(the compile-once/re-solve-many structure of LightningSimV2, arXiv
2404.09471, lifted to a batch of solves):

  1. regenerate the depth-dependent WAR edges for ALL K configs (the
     static SEQ+RAW skeleton is shared via
     :class:`~repro_torch.core.incremental.CompiledGraph`);
  2. run the chain-decomposed longest-path fixpoint with a batch axis;
  3. re-check every stored NB/probe constraint for all K configs in one
     vectorized pass;
  4. mask out structurally-infeasible configs (a committed blocking write
     whose target read never occurred ⇒ deadlock), cyclic configs (the
     regenerated event order is invalid) and constraint-violating configs,
     and fall back to a full re-simulation for exactly that subset.

Backends (``backend=``), and where they run:

  * ``"cuda"`` (default) — the sparse chain-structured fixpoint of
    ``repro_torch.kernels.maxplus.sparse`` (kernel 1): O(K·n + K·edges)
    device memory, WAR regeneration on the device.  The reference's
    ``"jax"`` lane.
  * ``"cuda_dense"`` — dense O(n²)-per-config max-plus sweeps of
    ``repro_torch.kernels.maxplus.kernel`` (kernel 2) with a one-sweep
    convergence certificate, for small graphs.  The reference's
    ``"jax_dense"`` lane.
  * ``"numpy"`` — the seeded Gauss-Seidel solver, and ``"reference"`` — the
    synchronous Jacobi :func:`~repro_torch.core.graph
    .longest_path_chains_batched`: verbatim host ports of the reference's
    solvers, and the port's exact oracles.

The two device lanes run on ``device=`` (default ``"cuda"``, which must
exist: pass ``device="cpu"`` to run their plain PyTorch versions).  Their
times stay on that device: the constraint re-check and the cycle maximum
run there in torch, and only ``status``, ``cycles`` and ``violated`` come
back to the host.
"""
from __future__ import annotations

import copy
import threading
import time as _time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..kernels._cuda import resolve_device
from .engine import OmniSim, simulate
from .graph import (export_chain_flat, longest_path_chains,
                    longest_path_chains_batched)
from .incremental import NEGI, CompiledGraph, compile_graph
from .program import SimResult

# per-config status codes.  The first four are solver verdicts (what
# ``solve_block_status`` classifies); the last four are *service-level*
# terminal statuses of the reference's sweep subsystem (``repro/sweep``),
# kept so codes mean the same in both packages.
REUSED, DEADLOCK, CYCLE, VIOLATED = 0, 1, 2, 3
CANCELLED, FAULTED, TIMED_OUT, REJECTED = 4, 5, 6, 7

# Per-Program re-entrant locks serializing every transient in-place
# mutation (the fallback re-simulation sets FIFO depths and restores
# them) against readers of that state on other threads.  Per Program, not
# global: unrelated designs must not stall behind one design's engine
# re-sims.
_LOCK_CREATE = threading.Lock()


def program_mutation_lock(program) -> threading.RLock:
    lock = getattr(program, "_mutation_lock", None)
    if lock is None:
        with _LOCK_CREATE:
            lock = getattr(program, "_mutation_lock", None)
            if lock is None:
                lock = threading.RLock()
                program._mutation_lock = lock
    return lock


_STATUS_REASON = {
    REUSED: "constraints satisfied",
    CYCLE: "regenerated WAR edges create a cycle (event order invalid)",
    CANCELLED: "request cancelled before this config was scheduled",
    FAULTED: "shard solve faulted repeatedly (retries exhausted)",
    TIMED_OUT: "deadline exceeded before this config was solved",
    REJECTED: "rejected by admission control",
}

# statuses the exact engine fallback applies to: solver verdicts that a
# full re-simulation can refine.  Service-level terminal statuses
# (CANCELLED/FAULTED/TIMED_OUT/REJECTED) must never pay for engine work.
FALLBACK_STATUSES = (DEADLOCK, CYCLE, VIOLATED)

BACKENDS = ("cuda", "cuda_dense", "numpy", "reference")
# configs per solver block when ``block`` is not given: the host solvers
# keep the reference's slab; the sparse kernel wants the whole batch on
# the card at once (one thread per chain and config)
_DEFAULT_BLOCK = {"cuda": 4096, "cuda_dense": 128, "numpy": 128,
                  "reference": 128}


@dataclass
class _BatchArrays:
    """Chain-major-permuted view of a CompiledGraph for batched solving."""

    perm: np.ndarray               # new pos -> original node idx
    inv: np.ndarray                # original node idx -> new pos
    slices: List[tuple]            # contiguous (lo, hi) per module chain
    starts: np.ndarray             # chain start offsets (for chain-of-node)
    cw: np.ndarray                 # cumulative SEQ weight, chain-major
    base_p: np.ndarray             # base contribution, chain-major (NEGI=none)
    raw_dst: np.ndarray            # RAW edges, chain-major columns
    raw_src: np.ndarray
    raw_w: np.ndarray
    raw_buckets: dict              # src chain -> [(dst chain, src, dst, w)]
    fifo_w_cols: List[np.ndarray]  # per FIFO: write node columns
    fifo_r_cols: List[np.ndarray]  # per FIFO: read node columns
    fifo_blocking: List[np.ndarray]
    fifo_need: np.ndarray          # min depth to avoid structural deadlock
    fifo_rchain: np.ndarray        # per FIFO: reader module chain (-1 = none)
    fifo_wchain: np.ndarray        # per FIFO: writer module chain (-1 = none)
    c_src_p: np.ndarray            # constraint source nodes, chain-major
    bound: int                     # upper bound on any acyclic path length
    t_inf: np.ndarray = None       # no-WAR (infinite-depth) fixpoint times
    c_inf: np.ndarray = None       # ... and its contribution vector
    war_cache: Dict[tuple, tuple] = field(default_factory=dict)
    sparse: object = None          # lazy ChainFlatArrays (sparse lane)
    on_device: Dict[tuple, object] = field(default_factory=dict)
    # ^ (what, device) -> tensors of this view already moved to a device

    def __getstate__(self):
        # device tensors stay in their process: a pickled view (a process
        # shard's graph) moves its arrays again on the other side
        state = dict(self.__dict__)
        del state["on_device"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.on_device = {}


def _chain_of(starts: np.ndarray, col: int) -> int:
    return int(np.searchsorted(starts, col, side="right") - 1)


def _batch_arrays(cache: CompiledGraph) -> _BatchArrays:
    if cache.batch is not None:
        return cache.batch
    n = cache.n
    perm = (np.concatenate(cache.chains) if cache.chains
            else np.zeros(0, np.int64))
    if len(perm) != n:
        raise ValueError("every node must belong to exactly one chain")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    slices, cw_parts, off = [], [], 0
    for ch in cache.chains:
        slices.append((off, off + len(ch)))
        cw_parts.append(np.cumsum(cache.seq_w[ch]))
        off += len(ch)
    cw = np.concatenate(cw_parts) if cw_parts else np.zeros(0, np.int64)
    starts = np.asarray([lo for (lo, _) in slices] or [0], np.int64)
    raw_dst = inv[cache.raw_dst]
    raw_src = inv[cache.raw_src]
    # the unique-destination invariant the batched scatter-max relies on:
    # one RAW in-edge per read node, one WAR in-edge per write node, and
    # read/write node sets are disjoint (engine construction guarantees it)
    if len(np.unique(raw_dst)) != len(raw_dst):
        raise ValueError(
            "RAW destinations must be unique for the batched fixpoint")
    # bucket RAW edges by (src chain, dst chain) for the Gauss-Seidel sweep
    raw_buckets: dict = {}
    if len(raw_dst):
        sc = np.searchsorted(starts, raw_src, side="right") - 1
        dc = np.searchsorted(starts, raw_dst, side="right") - 1
        order = np.lexsort((dc, sc))
        s_s, d_s = sc[order], dc[order]
        cut = np.flatnonzero(np.diff(s_s) | np.diff(d_s))
        bounds = np.concatenate([[0], cut + 1, [len(order)]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            idx = order[a:b]
            raw_buckets.setdefault(int(s_s[a]), []).append(
                (int(d_s[a]), raw_src[idx], raw_dst[idx], cache.raw_w[idx]))
    w_cols, r_cols, blocking, need, rchain, wchain = [], [], [], [], [], []
    for (w_nodes, r_nodes, blk) in cache.fifos:
        wc = inv[w_nodes] if len(w_nodes) else w_nodes
        rc = inv[r_nodes] if len(r_nodes) else r_nodes
        w_cols.append(wc)
        r_cols.append(rc)
        blocking.append(blk)
        rchain.append(_chain_of(starts, rc[0]) if len(rc) else -1)
        wchain.append(_chain_of(starts, wc[0]) if len(wc) else -1)
        if blk.any():
            w_seq = np.arange(1, len(w_nodes) + 1, dtype=np.int64)
            need.append(int(w_seq[blk].max()) - len(r_nodes))
        else:
            need.append(-(1 << 30))
    finite_base = cache.base[cache.base != NEGI]
    bound = int((finite_base.max() if len(finite_base) else 0)
                + cache.seq_w.sum() + cache.raw_w.sum()
                + sum(len(w) for (w, _, _) in cache.fifos) + 1)
    ba = _BatchArrays(
        perm=perm, inv=inv, slices=slices, starts=starts, cw=cw,
        base_p=cache.base[perm] if n else cache.base,
        raw_dst=raw_dst, raw_src=raw_src, raw_w=cache.raw_w,
        raw_buckets=raw_buckets,
        fifo_w_cols=w_cols, fifo_r_cols=r_cols, fifo_blocking=blocking,
        fifo_need=np.asarray(need, np.int64),
        fifo_rchain=np.asarray(rchain, np.int64),
        fifo_wchain=np.asarray(wchain, np.int64),
        c_src_p=(inv[cache.c_src] if len(cache.c_src) else cache.c_src),
        bound=bound)
    # depth-independent seed: the no-WAR (infinite-depth) fixpoint is a
    # lower bound of every config's fixpoint (WAR edges only delay), so the
    # per-config solve starts from it and pays only for the WAR impact
    if n:
        t_inf = longest_path_chains(cache.chains, cache.seq_w, cache.base,
                                    cache.raw_dst, cache.raw_src,
                                    cache.raw_w)[perm]
        c_inf = ba.base_p.copy()
        if len(raw_dst):
            c_inf[raw_dst] = np.maximum(c_inf[raw_dst],
                                        t_inf[raw_src] + cache.raw_w)
    else:
        t_inf = np.zeros(0, np.int64)
        c_inf = np.zeros(0, np.int64)
    ba.t_inf = t_inf
    ba.c_inf = c_inf
    cache.batch = ba
    return ba


def _war_cols(ba: _BatchArrays, fid: int, S: int):
    """Cached per-(FIFO, depth) regenerated-WAR columns.

    Returns (src_col, valid_col, cand_inf): for each of the FIFO's writes,
    the chain-major column of its (w-S)-th read, whether the edge exists
    under depth S (blocking, target read committed), and the edge's
    candidate contribution under the no-WAR seed times (NEGI = none).
    """
    key = (fid, S)
    hit = ba.war_cache.get(key)
    if hit is not None:
        return hit
    w_cols = ba.fifo_w_cols[fid]
    r_cols = ba.fifo_r_cols[fid]
    nw, nr = len(w_cols), len(r_cols)
    w_seq = np.arange(1, nw + 1, dtype=np.int64)
    tgt = w_seq - S - 1
    valid = ba.fifo_blocking[fid] & (tgt >= 0) & (tgt < nr)
    src = (r_cols[np.clip(tgt, 0, nr - 1)] if nr
           else np.zeros(nw, np.int64))
    cand = np.where(valid, ba.t_inf[src] + 1, NEGI)
    # a depth whose candidates cannot move the no-WAR fixpoint needs no
    # seed push at all (slack WAR — the common case when depths grow)
    effective = bool((cand > ba.c_inf[w_cols]).any())
    entry = (src, valid, cand, effective)
    ba.war_cache[key] = entry
    return entry


@dataclass
class BatchOutcome:
    """Result of :func:`resimulate_batch` over K depth configurations."""

    ok: np.ndarray                 # (K,) bool: graph reused for this config
    cycles: np.ndarray             # (K,) int64: cycle count (-1 = no result)
    status: np.ndarray             # (K,) int8: REUSED/DEADLOCK/CYCLE/VIOLATED
    violated: np.ndarray           # (K,) int64: # of flipped constraints
    reasons: List[str]
    results: List[Optional[SimResult]]
    elapsed_s: float
    fixpoint_rounds: int = 0
    n_unique: int = 0              # distinct depth rows actually solved

    @property
    def n_reused(self) -> int:
        return int(self.ok.sum())

    @property
    def n_fallback(self) -> int:
        return len(self.ok) - self.n_reused

    def us_per_config(self) -> float:
        return self.elapsed_s / max(len(self.ok), 1) * 1e6


def _regen_war_stacked(ba: _BatchArrays, Db: np.ndarray):
    """Stacked WAR regeneration for the reference (Jacobi) backend.

    Returns (dyn_dst (m,), dyn_src (B, m), dyn_valid (B, m)) covering every
    FIFO that can overflow for at least one config in the block; entry
    (k, j) is the regenerated WAR edge of the j-th write under config k
    (masked False where w <= S_k, the write is non-blocking, or the target
    read does not exist).
    """
    B = len(Db)
    dst_parts, src_parts, valid_parts = [], [], []
    for fid, w_cols in enumerate(ba.fifo_w_cols):
        nw = len(w_cols)
        if nw == 0 or int(Db[:, fid].min()) >= nw:
            continue                       # no config overflows this FIFO
        r_cols = ba.fifo_r_cols[fid]
        nr = len(r_cols)
        w_seq = np.arange(1, nw + 1, dtype=np.int64)
        tgt = w_seq[None, :] - Db[:, fid][:, None] - 1        # (B, nw)
        valid = ba.fifo_blocking[fid][None, :] & (tgt >= 0) & (tgt < nr)
        if nr:
            src = r_cols[np.clip(tgt, 0, nr - 1)]
        else:
            src = np.zeros((B, nw), np.int64)
        dst_parts.append(w_cols)
        src_parts.append(src)
        valid_parts.append(valid)
    if not dst_parts:
        z = np.zeros(0, np.int64)
        return z, np.zeros((B, 0), np.int64), np.zeros((B, 0), bool)
    return (np.concatenate(dst_parts),
            np.concatenate(src_parts, axis=1),
            np.concatenate(valid_parts, axis=1))


def _constraint_groups(cache: CompiledGraph, ba: _BatchArrays, device):
    """Per-FIFO constraint index tensors on ``device`` (cached on ``ba``):
    ``(c_src_p, c_out, groups)``, each group ``(fid, rd, rd_tgt, rd_exists,
    wr, wr_seq, w_cols, r_cols)`` with ``rd``/``wr`` the constraint rows
    of that FIFO's can-read / can-write checks."""
    key = ("constraints", str(device))
    hit = ba.on_device.get(key)
    if hit is not None:
        return hit

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    groups = []
    for fid in range(len(cache.fifos)):
        sel = np.flatnonzero(cache.c_fifo == fid)
        if not len(sel):
            continue
        nw = len(ba.fifo_w_cols[fid])
        seq, kind = cache.c_seq[sel], cache.c_kind[sel]
        rd, wr = kind == 0, kind == 1
        groups.append((
            fid, dev(sel[rd]),
            # reads: target = seq-th write (config-independent)
            dev(np.minimum(seq[rd] - 1, max(nw - 1, 0))),
            torch.as_tensor((seq[rd] - 1) < nw, device=device),
            dev(sel[wr]), dev(seq[wr]),
            dev(ba.fifo_w_cols[fid]), dev(ba.fifo_r_cols[fid])))
    entry = (dev(ba.c_src_p), torch.as_tensor(cache.c_out, device=device),
             groups)
    ba.on_device[key] = entry
    return entry


def _check_constraints_stacked(cache: CompiledGraph, ba: _BatchArrays,
                               t: torch.Tensor, Db: torch.Tensor):
    """Vectorized Table-2 re-check of all constraints for a block of configs.

    ``t``: (n, B) node times in chain-major (node-major) layout, a tensor
    on the solver's device; ``Db``: (B, F) int64 depths on that device.
    Returns the (B,) int64 tensor of flipped constraint outcomes (0 ⇒
    reusable), computed on that device.
    """
    nC = len(cache.c_kind)
    B = Db.shape[0]
    if nC == 0:
        return torch.zeros(B, dtype=torch.int64, device=t.device)
    c_src_p, c_out, groups = _constraint_groups(cache, ba, t.device)
    ok = torch.zeros((nC, B), dtype=torch.bool, device=t.device)
    st = t[c_src_p]                                           # (nC, B)
    for (fid, rd, rd_tgt, rd_exists, wr, wr_seq, w_cols, r_cols) in groups:
        nw, nr = w_cols.shape[0], r_cols.shape[0]
        if rd.shape[0]:
            if nw:
                t_tgt = t[w_cols[rd_tgt]]
            else:
                t_tgt = torch.zeros((rd.shape[0], B), dtype=t.dtype,
                                    device=t.device)
            ok[rd] = rd_exists[:, None] & (t_tgt < st[rd])
        if wr.shape[0]:
            # writes: trivially true if seq <= S, else target read (per config)
            seq_w = wr_seq[:, None]                           # (m, 1)
            S = Db[None, :, fid]                              # (1, B)
            triv = seq_w <= S
            tgt_w = seq_w - S - 1                             # (m, B)
            exists_w = tgt_w < nr
            if nr:
                idx = r_cols[torch.clamp(tgt_w, 0, nr - 1)]
                t_tgt_w = torch.gather(t, 0, idx)
            else:
                t_tgt_w = torch.zeros(tgt_w.shape, dtype=t.dtype,
                                      device=t.device)
            ok[wr] = triv | (exists_w & (t_tgt_w < st[wr]))
    return (ok != c_out[:, None]).sum(dim=0)


def _solve_block_reference(ba: _BatchArrays, Db: np.ndarray):
    """Jacobi reference solve via :func:`longest_path_chains_batched`
    (one synchronized cross pass per round; the testing oracle)."""
    B = len(Db)
    n = len(ba.perm)
    if ba.bound < (1 << 28):
        dtype, NEG = np.int32, -(1 << 29)
    else:
        dtype, NEG = np.int64, int(NEGI)
    base = np.where(ba.base_p == NEGI, NEG, ba.base_p).astype(dtype)
    base = np.broadcast_to(base, (B, n)).copy()
    dyn_dst, dyn_src, dyn_valid = _regen_war_stacked(ba, Db)
    times_p, conv, rounds = longest_path_chains_batched(
        ba.slices, ba.cw.astype(dtype), base,
        ba.raw_dst, ba.raw_src, ba.raw_w.astype(dtype),
        dyn_dst, dyn_src, dyn_valid, bound=ba.bound)
    return np.ascontiguousarray(times_p.T), conv, rounds


def _solve_block_numpy(ba: _BatchArrays, Db: np.ndarray):
    """Batched seeded Gauss-Seidel fixpoint for one block of configs.

    Node-major ``(n, K)`` layout (cross-edge gathers/scatters hit
    contiguous K-wide rows; the per-chain cummax streams contiguous
    slabs).  Every config starts AT the no-WAR fixpoint, its regenerated
    WAR candidates (per-(FIFO, depth) cached columns) are applied once,
    and then chains are swept in module order with per-(chain, config)
    dirty tracking — so a sweep recomputes only the chains some config's
    WAR constraints actually moved, and slack configs converge with zero
    sweeps.  int32 when the path-length bound allows (halves the traffic).

    Returns (times (n, K) in solve dtype, converged (K,), sweeps).
    Non-converged configs (WAR cycle: times grow past the acyclic bound,
    or the sweep cap is hit) report False and undefined times.
    """
    K = len(Db)
    n = len(ba.perm)
    if ba.bound < (1 << 28):
        dtype, NEG = np.int32, -(1 << 29)
    else:
        dtype, NEG = np.int64, int(NEGI)
    conv_out = np.ones(K, dtype=bool)
    if n == 0 or K == 0:
        return np.zeros((n, K), dtype), conv_out, 0
    cw = ba.cw.astype(dtype)
    t_seed = np.maximum(ba.t_inf, NEG).astype(dtype)
    c_seed = np.maximum(ba.c_inf, NEG).astype(dtype)
    c = np.empty((n, K), dtype=dtype)
    c[:] = c_seed[:, None]
    t = np.empty((n, K), dtype=dtype)
    t[:] = t_seed[:, None]
    nch = len(ba.slices)
    dirty = np.zeros((nch, K), dtype=bool)
    # ---- seed pass: apply each config's WAR candidates over t_inf ----
    war_entries = []        # [rchain, wchain, dcols, src_mat, val_mat, inv]
    for fid, w_cols in enumerate(ba.fifo_w_cols):
        nw = len(w_cols)
        if nw == 0 or int(Db[:, fid].min()) >= nw:
            continue                       # no config overflows this FIFO
        if len(ba.fifo_r_cols[fid]) == 0:
            continue       # blocking overflow ⇒ already masked as deadlock
        uniq, invq = np.unique(Db[:, fid], return_inverse=True)
        cols = [_war_cols(ba, fid, int(S)) for S in uniq]
        src_mat = np.stack([cc[0] for cc in cols], axis=1)    # (nw, u)
        val_mat = np.stack([cc[1] for cc in cols], axis=1)
        if any(cc[3] for cc in cols):      # some depth's WAR binds at seed
            cand_mat = np.maximum(np.stack([cc[2] for cc in cols], axis=1),
                                  NEG).astype(dtype)
            cand = cand_mat[:, invq]                          # (nw, K)
            old = c[w_cols]
            np.maximum(cand, old, out=cand)
            chm = cand != old
            if chm.any():
                c[w_cols] = cand
                dirty[int(ba.fifo_wchain[fid])] |= chm.any(axis=0)
        war_entries.append([int(ba.fifo_rchain[fid]),
                            int(ba.fifo_wchain[fid]), w_cols,
                            src_mat, val_mat, invq])
    war_by_reader: dict = {}
    for e in war_entries:
        war_by_reader.setdefault(e[0], []).append(e)

    times_out = None
    act = np.arange(K)
    sweeps = 0
    max_sweeps = n + 2
    while True:
        # ---- retire configs with no pending chains (or diverged) ----
        pend = dirty.any(axis=0)
        if sweeps >= 8 or not pend.any():
            over = (t > ba.bound).any(axis=0)
        else:
            over = np.zeros(len(act), dtype=bool)
        done = ~pend | over
        if done.any():
            if done.all() and len(act) == K:
                # fast path: the whole block settles at once — hand the
                # working matrix back without the (n, K) copy
                conv_out[act] = ~over
                return t, conv_out, sweeps
            if times_out is None:
                times_out = np.empty((n, K), dtype=dtype)
            rows = act[done]
            times_out[:, rows] = t[:, done]
            conv_out[rows] = ~over[done]
            if done.all():
                break
            keep = ~done
            act = act[keep]
            c = np.ascontiguousarray(c[:, keep])
            t = np.ascontiguousarray(t[:, keep])
            dirty = np.ascontiguousarray(dirty[:, keep])
            for e in war_entries:
                e[5] = e[5][keep]
        if sweeps >= max_sweeps:
            if times_out is None:
                times_out = np.empty((n, K), dtype=dtype)
            times_out[:, act] = t                  # cap hit: cyclic leftovers
            conv_out[act] = False
            break
        sweeps += 1
        # ---- one Gauss-Seidel sweep over dirty chains, module order ----
        for ci in range(nch):
            if not dirty[ci].any():
                continue
            dirty[ci] = False
            lo, hi = ba.slices[ci]
            seg = c[lo:hi] - cw[lo:hi, None]
            np.maximum.accumulate(seg, axis=0, out=seg)
            seg += cw[lo:hi, None]
            if np.array_equal(seg, t[lo:hi]):
                continue                   # no new times ⇒ pushes stand
            t[lo:hi] = seg
            for (dc, scols, dcols, w) in ba.raw_buckets.get(ci, ()):
                cand = t[scols] + w[:, None].astype(dtype)
                old = c[dcols]
                np.maximum(cand, old, out=cand)
                chm = cand != old
                if chm.any():
                    c[dcols] = cand
                    dirty[dc] |= chm.any(axis=0)
            for e in war_by_reader.get(ci, ()):
                wc, dcols, src_mat, val_mat, invq = \
                    e[1], e[2], e[3], e[4], e[5]
                src_idx = src_mat[:, invq]                    # (nw, K_act)
                cand = np.take_along_axis(t, src_idx, axis=0)
                cand += 1
                old = c[dcols]
                cand = np.where(val_mat[:, invq], cand, old)
                np.maximum(cand, old, out=cand)
                chm = cand != old
                if chm.any():
                    c[dcols] = cand
                    dirty[wc] |= chm.any(axis=0)
    return times_out, conv_out, sweeps


def solve_block_status(cache: CompiledGraph, depth_block,
                       backend: str = "cuda", block: Optional[int] = None,
                       device="cuda"):
    """Engine-free solve phase of :func:`resimulate_batch`.

    Classifies a block of depth vectors against ``cache`` alone — no
    ``OmniSim`` engine, no Python generators, no fallback re-simulation.

    ``backend``: one of :data:`BACKENDS` (see the module docstring);
    ``block`` bounds the configs solved at once (default per backend);
    ``device`` is where the ``"cuda"`` / ``"cuda_dense"`` lanes run — a
    CUDA device by default, which must exist (``device="cpu"`` runs their
    plain PyTorch versions); the host lanes ignore it.

    Returns ``(status, cycles, violated, fixpoint_rounds)`` as host numpy
    arrays — per config: REUSED with its exact cycle count, or DEADLOCK /
    CYCLE / VIOLATED with ``cycles = -1`` (the caller decides whether to
    pay for the exact fallback re-simulation, which *does* need the
    engine).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    on_host = backend in ("numpy", "reference")
    dev = torch.device("cpu") if on_host else resolve_device(device)
    step = max(int(block or _DEFAULT_BLOCK[backend]), 1)
    ba = _batch_arrays(cache)
    D = np.asarray(depth_block, dtype=np.int64)
    if D.ndim == 1:
        D = D[None, :]
    K = len(D)
    status = np.zeros(K, dtype=np.int8)
    cycles = np.full(K, -1, dtype=np.int64)
    violated = np.zeros(K, dtype=np.int64)
    # ① structural infeasibility: committed blocking write whose target
    # read never occurred can never commit — deadlock under these depths
    dead = (D < ba.fifo_need[None, :]).any(axis=1)
    status[dead] = DEADLOCK
    alive = np.flatnonzero(~dead)
    total_rounds = 0

    if len(alive):
        if backend == "cuda_dense":
            blocks = [(np.arange(len(alive)),
                       *_solve_dense_cuda(cache, ba, D[alive], dev, step))]
        else:
            if backend == "numpy":
                solve = _solve_block_numpy
            elif backend == "reference":
                solve = _solve_block_reference
            else:           # sparse chain-structured CUDA max-plus lane
                solve = (lambda ba_, Db_: _solve_sparse_cuda(
                    cache, ba_, Db_, dev))
            blocks = []
            for lo in range(0, len(alive), step):
                sl = np.arange(lo, min(lo + step, len(alive)))
                t_nm, conv, rounds = solve(ba, D[alive[sl]])
                total_rounds = max(total_rounds, rounds)
                blocks.append((sl, t_nm, conv))
        for sl, t_nm, conv in blocks:
            if on_host:
                t_nm = torch.from_numpy(np.ascontiguousarray(t_nm))
            conv = torch.as_tensor(conv, device=dev)
            rows = alive[sl]
            Db = torch.as_tensor(D[rows], device=dev)
            # ③ constraint re-check and cycle count, on the solver's device
            viol = _check_constraints_stacked(cache, ba, t_nm, Db)
            cyc = (t_nm.max(dim=0).values if t_nm.shape[0]
                   else torch.zeros(len(rows), dtype=t_nm.dtype, device=dev))
            conv, viol, cyc = (x.cpu().numpy() for x in (conv, viol, cyc))
            status[rows[~conv]] = CYCLE                       # ② event order
            violated[rows[conv]] = viol[conv]
            status[rows[conv & (viol > 0)]] = VIOLATED
            good = conv & (viol == 0)
            cycles[rows[good]] = cyc[good]
    return status, cycles, violated, total_rounds


def status_reason(cache: CompiledGraph, status_k: int, violated_k: int,
                  depths_row: np.ndarray,
                  fifo_names: Optional[List[str]] = None) -> str:
    """Human-readable verdict for one config of :func:`solve_block_status`
    (exactly the strings :func:`resimulate_batch` reports)."""
    if status_k in _STATUS_REASON:
        return _STATUS_REASON[status_k]
    if status_k == DEADLOCK:
        ba = _batch_arrays(cache)
        fid = int(np.flatnonzero(depths_row < ba.fifo_need)[0])
        name = fifo_names[fid] if fifo_names else f"fifo{fid}"
        return (f"a committed write on '{name}' can never commit "
                f"with depth {int(depths_row[fid])} (would deadlock)")
    return (f"{int(violated_k)} constraint(s) violated — "
            f"control/data flow diverges")


def materialize_block(result: SimResult, Du: np.ndarray,
                      status_u: np.ndarray, cycles_u: np.ndarray,
                      violated_u: np.ndarray, fallback_mask: np.ndarray,
                      engine_label: str = "omnisim-batch", lock=None):
    """Post-solve verdict assembly shared by :func:`resimulate_batch` and
    the sweep scheduler (``repro_torch/sweep/scheduler.py``).

    For each unique depth row: the human-readable reason string, a
    lightweight REUSED :class:`SimResult` shell carrying the solved cycle
    count (labelled ``engine_label``), or — where ``fallback_mask`` allows
    — the exact fallback full re-simulation (``cycles_u`` is updated in
    place with its result).  The fallback holds the program's mutation
    lock, and ``lock`` too where given: it temporarily sets the Program's
    FIFO depths.  The sweep scheduler passes the design's entry lock;
    direct library calls need none.  Returns ``(results_u, reasons_u)``.
    """
    engine: OmniSim = result.graph
    cache = compile_graph(engine)
    fifo_names = [f.name for f in engine.fifos]
    U = len(Du)
    results_u: List[Optional[SimResult]] = [None] * U
    reasons_u: List[str] = [""] * U
    for u in range(U):
        reasons_u[u] = status_reason(cache, int(status_u[u]),
                                     int(violated_u[u]), Du[u], fifo_names)
        if status_u[u] == REUSED:
            # per-shell copies: SimStats is a mutable dataclass and
            # constraints a mutable list — sharing them would let a caller
            # mutating one sweep result corrupt its siblings AND the cached
            # base run (the graph stays shared by design: it IS the cache)
            results_u[u] = SimResult(
                program=result.program, outputs=dict(result.outputs),
                cycles=int(cycles_u[u]), engine=engine_label,
                stats=copy.copy(result.stats), graph=engine,
                constraints=list(result.constraints),
                depths=tuple(int(d) for d in Du[u]))
        elif fallback_mask[u] and status_u[u] in FALLBACK_STATUSES:
            with (lock if lock is not None else nullcontext()), \
                    program_mutation_lock(engine.program):
                saved = engine.program.depths()
                try:
                    full = simulate(engine.program,
                                    depths=tuple(int(d) for d in Du[u]))
                finally:
                    engine.program.with_depths(saved)
            results_u[u] = full
            cycles_u[u] = full.cycles
    return results_u, reasons_u


def resimulate_batch(result: SimResult, depth_matrix,
                     fallback: bool = True, backend: str = "cuda",
                     block: Optional[int] = None, dedup: bool = True,
                     device="cuda") -> BatchOutcome:
    """Incrementally re-simulate ``result`` under K depth vectors at once.

    ``depth_matrix``: (K, n_fifos) array-like of candidate depths.  Returns
    a :class:`BatchOutcome` whose k-th entry is exactly what
    ``resimulate(result, depth_matrix[k])`` would report — reusable configs
    get their cycle count from the shared batched fixpoint; deadlocked,
    cyclic or constraint-violating configs fall back to a full
    re-simulation (``fallback=True``) of just that config.

    ``dedup`` (default True) collapses identical depth rows before solving:
    only the unique rows pay for the fixpoint, the constraint re-check AND
    any fallback re-simulation — duplicate rows share one result object
    (``BatchOutcome.n_unique``).

    ``backend``, ``block`` and ``device`` are those of
    :func:`solve_block_status`: by default the sparse CUDA kernel on the
    card.
    """
    t0 = _time.perf_counter()
    engine: OmniSim = result.graph
    if not isinstance(engine, OmniSim):
        raise TypeError("batched re-sim needs an OmniSim result")
    D = np.asarray(depth_matrix, dtype=np.int64)
    if D.ndim == 1:
        D = D[None, :]
    K, F = D.shape
    if F != len(engine.fifos):
        raise ValueError(f"depth_matrix has {F} columns for "
                         f"{len(engine.fifos)} FIFOs")
    cache = compile_graph(engine)

    if dedup and K > 1:
        Du, inverse = np.unique(D, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)      # numpy 2 keeps the input's ndim
    else:
        Du, inverse = D, np.arange(K)
    U = len(Du)
    status_u, cycles_u, violated_u, total_rounds = solve_block_status(
        cache, Du, backend=backend, block=block, device=device)

    # ④ fall back to full re-simulation for exactly the failed subset —
    # once per unique config; duplicate rows share the result object
    results_u, reasons_u = materialize_block(
        result, Du, status_u, cycles_u, violated_u,
        np.full(U, bool(fallback)))

    status = status_u[inverse]
    return BatchOutcome(ok=status == REUSED, cycles=cycles_u[inverse],
                        status=status, violated=violated_u[inverse],
                        reasons=[reasons_u[i] for i in inverse],
                        results=[results_u[i] for i in inverse],
                        elapsed_s=_time.perf_counter() - t0,
                        fixpoint_rounds=total_rounds, n_unique=U)


# ---------------------------------------------------------------------------
# device lanes: sparse CUDA fixpoint + dense CUDA sweeps
# ---------------------------------------------------------------------------
# Working-set ceiling for the dense lane: K * n^2 int32 entries per slab.
# A module constant so regression tests can shrink it and exercise the
# chunking/error paths without gigabyte batches.
_DENSE_CAP = 1 << 27


def _int32_saturation_guard(ba: _BatchArrays, backend: str) -> None:
    """Refuse int32 device solves when finite times could exceed int32.

    ``ba.bound`` bounds every finite (acyclic) node time and the numpy
    path switches to int64 at ``2^28``; the device lanes are int32-only, so
    past that point a silently wrapped time could flip a constraint
    comparison.  Raise instead of wrapping.
    """
    if ba.bound >= (1 << 28):
        raise ValueError(
            f"backend={backend!r} solves in int32 but the graph's "
            f"path-length bound {ba.bound} >= 2^28 risks overflow; "
            f"use backend='numpy' (int64) for this design")


def _sparse_arrays(ba: _BatchArrays, device):
    """Chain-flat transfer arrays of the sparse lane, built once per graph
    and moved once per device (both cached on ``ba``)."""
    from ..kernels.maxplus import sparse as sp

    if ba.sparse is None:
        ba.sparse = export_chain_flat(
            ba.slices, ba.cw, ba.c_inf, ba.raw_dst, ba.raw_src, ba.raw_w,
            ba.fifo_w_cols, ba.fifo_r_cols, ba.fifo_blocking,
            bound=ba.bound, neg=sp.NEG)
    key = ("sparse", str(device))
    if key not in ba.on_device:
        ba.on_device[key] = sp.to_device(ba.sparse, device)
    return ba.on_device[key]


def _solve_sparse_cuda(cache: CompiledGraph, ba: _BatchArrays,
                       Db: np.ndarray, device):
    """Sparse chain-structured solve for one block of configs.

    Seeds every config at the no-WAR fixpoint contribution (``c_inf``, a
    lower bound of every least fixpoint) and iterates the Jacobi
    chain-pass/cross-pass to the same unique least fixpoint the numpy
    Gauss-Seidel reaches — times, and hence statuses/cycles/violations,
    are bit-identical for converged rows.  Returns device tensors.
    """
    from ..kernels.maxplus.sparse import solve_chains

    _int32_saturation_guard(ba, "cuda")
    arr = _sparse_arrays(ba, device)
    Dp = np.minimum(np.asarray(Db, np.int64), 1 << 30).astype(np.int32)
    return solve_chains(arr, torch.from_numpy(Dp).to(device))


def _dense_skeleton(cache: CompiledGraph, device):
    """The depth-independent half of the dense lane's input: the (n, n)
    int32 max-plus adjacency of the SEQ + RAW edges (``A[i, j]`` = weight
    of j -> i, else -INF) and the base vector, on ``device``."""
    from ..kernels.maxplus.kernel import NEG as NEG32

    n = cache.n
    # clip int64 weights against the kernel's -INF before the int32 cast —
    # a bare .astype would wrap NEGI into a huge positive phantom edge
    b = np.maximum(cache.base, NEG32).astype(np.int32)
    A = np.full((n, n), NEG32, dtype=np.int32)
    for ch in cache.chains:                      # SEQ skeleton
        if len(ch) > 1:
            A[ch[1:], ch[:-1]] = np.maximum(
                cache.seq_w[ch[1:]], NEG32).astype(np.int32)
    A[cache.raw_dst, cache.raw_src] = np.maximum(
        cache.raw_w, NEG32).astype(np.int32)
    return torch.from_numpy(A).to(device), torch.from_numpy(b).to(device)


def _dense_adjacency(cache: CompiledGraph, A: torch.Tensor,
                     Ds: np.ndarray) -> torch.Tensor:
    """``(len(Ds), n, n)`` adjacencies: the skeleton ``A`` with each
    config's regenerated WAR edges (weight 1) scattered in, on A's
    device."""
    AK = A.expand(len(Ds), *A.shape).clone()
    parts = []
    for fid, (w_nodes, r_nodes, blk) in enumerate(cache.fifos):
        nw, nr = len(w_nodes), len(r_nodes)
        if nw == 0 or int(Ds[:, fid].min()) >= nw:
            continue
        w_seq = np.arange(1, nw + 1, dtype=np.int64)
        tgt = w_seq[None, :] - Ds[:, fid][:, None] - 1
        valid = blk[None, :] & (tgt >= 0) & (tgt < nr)
        kk, jj = np.nonzero(valid)
        parts.append((kk, w_nodes[jj], r_nodes[tgt[kk, jj]]))
    if parts:
        kk, ww, rr = (torch.from_numpy(np.concatenate(p)).to(A.device)
                      for p in zip(*parts))
        AK[kk, ww, rr] = 1
    return AK


def _solve_dense_cuda(cache: CompiledGraph, ba: _BatchArrays, Db: np.ndarray,
                      device, block: int):
    """Batched node times through the dense max-plus sweep (kernel 2).

    Builds dense ``(slab, n, n)`` max-plus adjacencies on the device
    (:func:`_dense_skeleton` broadcast, per-config WAR entries scattered
    in) and iterates each slab to its fixpoint, chunking the batch so one
    slab never exceeds ``_DENSE_CAP`` int32 entries (a *single* config
    past the cap is a hard error).  Convergence is certified by one extra
    sweep: non-converged rows (WAR cycles) report False.  Returns
    ``(times (n, K) int32, converged (K,) bool)`` on the device.
    """
    from ..kernels.maxplus.kernel import maxplus_sweep
    from ..kernels.maxplus.ops import longest_path

    n = cache.n
    K = len(Db)
    if n * n > _DENSE_CAP:
        raise ValueError(
            f"dense backend needs n^2 <= {_DENSE_CAP} per config "
            f"(got {n}^2); use backend='numpy' (or the sparse "
            f"backend='cuda') for large graphs")
    _int32_saturation_guard(ba, "cuda_dense")
    if n == 0:
        return (torch.zeros((0, K), dtype=torch.int32, device=device),
                torch.ones(K, dtype=torch.bool, device=device))
    slab = max(1, min(block, _DENSE_CAP // (n * n)))
    A, b = _dense_skeleton(cache, device)
    times_parts, conv_parts = [], []
    for lo in range(0, K, slab):
        AK = _dense_adjacency(cache, A, Db[lo:lo + slab])
        tK = longest_path(AK, b)
        # certify fixpoint: one more sweep must be a no-op (cycles diverge)
        conv_parts.append((maxplus_sweep(AK, tK, b) == tK).all(dim=1))
        times_parts.append(tK)
    times = torch.cat(times_parts)
    perm = torch.from_numpy(ba.perm).to(device)
    return times[:, perm].T.contiguous(), torch.cat(conv_parts)
