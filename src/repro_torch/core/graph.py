"""The (partial) simulation graph and its finalization pass.

PyTorch-port copy of ``repro.core.graph`` (host logic, numpy).
Construction uses an adjacency list with edges stored *alongside* each node
(paper Sec. 7.3.1) so the orchestrator can traverse the incomplete graph
zero-copy while resolving queries.  Finalization — computing every node's
hardware cycle as the longest path from the virtual start — exploits the
invariant that **node creation order is a topological order** (a node's
predecessors always exist before it), so a single forward pass suffices.

Longest-path backends:

  * ``longest_path_numpy`` — vectorized CSR forward pass over levels
    (production path on the host; reference for the others).
  * ``longest_path_chains`` / ``longest_path_chains_batched`` — the
    chain-decomposed fixpoints the incremental and batched re-solves use.
  * ``repro_torch.kernels.maxplus`` — hand-written CUDA kernels: the
    sparse chain-structured fixpoint over :class:`ChainFlatArrays`, and
    the dense max-plus sweep over :func:`to_dense_blocks` matrices.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from .events import Node, NodeKind


class SimGraph:
    """Append-only adjacency-list simulation graph."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []

    # -- construction ----------------------------------------------------------
    def add_node(self, module: int, kind: NodeKind, time: int,
                 fifo: int = -1, seq: int = -1) -> Node:
        n = Node(idx=len(self.nodes), module=module, kind=kind, time=time,
                 fifo=fifo, seq=seq)
        self.nodes.append(n)
        return n

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return sum(len(n.preds) for n in self.nodes)

    # -- export -----------------------------------------------------------------
    def to_csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """CSR by *destination*: (indptr, src, weight, base).

        ``base[i]`` is the node's schedule-intrinsic earliest time (its
        recorded time is max(base, preds)); for reconstruction we only need
        edges + base because times were computed eagerly: base is derived as
        the recorded time when the node has no preds, else 0 (edges carry the
        stall structure; intra-module sequencing is itself an edge).
        """
        n = len(self.nodes)
        indptr = np.zeros(n + 1, dtype=np.int64)
        for i, node in enumerate(self.nodes):
            indptr[i + 1] = indptr[i] + len(node.preds)
        m = int(indptr[-1])
        src = np.zeros(m, dtype=np.int64)
        wgt = np.zeros(m, dtype=np.int64)
        base = np.zeros(n, dtype=np.int64)
        k = 0
        for i, node in enumerate(self.nodes):
            if not node.preds:
                base[i] = node.time
            for (s, w) in node.preds:
                src[k] = s
                wgt[k] = w
                k += 1
        return indptr, src, wgt, base

    def times(self) -> np.ndarray:
        return np.array([n.time for n in self.nodes], dtype=np.int64)


# ------------------------------------------------------------------------------
# Longest-path backends
# ------------------------------------------------------------------------------
def longest_path_python(indptr: np.ndarray, src: np.ndarray, wgt: np.ndarray,
                        base: np.ndarray) -> np.ndarray:
    """O(V+E) forward pass in creation (= topological) order."""
    n = len(base)
    t = base.astype(np.int64).copy()
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        for k in range(lo, hi):
            cand = t[src[k]] + wgt[k]
            if cand > t[i]:
                t[i] = cand
    return t


def level_schedule(indptr: np.ndarray, src: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Group nodes into levels where level(i) = 1 + max(level(preds)).

    Nodes within a level have no edges among themselves, so each level can be
    relaxed fully in parallel (level-synchronous max-plus) — this is the
    parallel structure the vectorized numpy backend uses.

    Node numbering need NOT be topological (the decoupled baseline's traces
    are not); a Kahn pass computes levels for any DAG and raises on cycles.
    """
    n = len(indptr) - 1
    if n == 0:
        return np.zeros(0, dtype=np.int64), []
    indeg = np.diff(indptr).astype(np.int64)
    # out-adjacency (CSR by source) — fully vectorized Kahn below: each wave
    # gathers all frontier out-edges with the offset trick, bumps target
    # levels with maximum.at, and decrements indegrees with bincount.
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(src, kind="stable")
    out_dst = dst[order]
    out_counts = np.bincount(src, minlength=n)
    out_indptr = np.concatenate([[0], np.cumsum(out_counts)]).astype(np.int64)

    level = np.zeros(n, dtype=np.int64)
    frontier = np.flatnonzero(indeg == 0)
    levels: List[np.ndarray] = []
    done = 0
    while len(frontier):
        levels.append(frontier)
        done += len(frontier)
        starts = out_indptr[frontier]
        counts = (out_indptr[frontier + 1] - starts)
        total = int(counts.sum())
        if total == 0:
            break
        offs = np.repeat(starts - np.concatenate(
            [[0], np.cumsum(counts)[:-1]]), counts)
        idx = np.arange(total, dtype=np.int64) + offs
        targets = out_dst[idx]
        lvl_edge = np.repeat(level[frontier] + 1, counts)
        np.maximum.at(level, targets, lvl_edge)
        dec = np.bincount(targets, minlength=n)
        indeg -= dec
        frontier = np.flatnonzero((indeg == 0) & (dec > 0))
    if done != n:
        raise ValueError("simulation graph contains a cycle")
    return level, levels


def longest_path_numpy(indptr: np.ndarray, src: np.ndarray, wgt: np.ndarray,
                       base: np.ndarray,
                       levels: Sequence[np.ndarray] = None) -> np.ndarray:
    """Vectorized level-synchronous forward pass."""
    n = len(base)
    t = base.astype(np.int64).copy()
    if levels is None:
        _, levels = level_schedule(indptr, src)
    for nodes in levels:
        # gather all incoming edges of this level's nodes at once
        starts = indptr[nodes]
        counts = (indptr[nodes + 1] - starts).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            continue
        offs = np.repeat(starts - np.concatenate(
            [[0], np.cumsum(counts)[:-1]]), counts)
        edge_idx = np.arange(total, dtype=np.int64) + offs
        owner = np.repeat(np.arange(len(nodes)), counts)
        cand = t[src[edge_idx]] + wgt[edge_idx]
        upd = t[nodes].copy()
        np.maximum.at(upd, owner, cand)
        t[nodes] = upd
    return t


def longest_path_chains(chains, seq_w, base, cross_dst, cross_src, cross_w,
                        max_iters: int = 0):
    """Chain-decomposed longest path (vectorized fixpoint).

    The simulation graph is a set of per-module *chains* (SEQ edges with
    additive weights) plus sparse cross-module edges (RAW/WAR).  Within a
    chain, t[i] = CW[i] + cummax(c[i] - CW[i]) where CW is the cumulative
    SEQ weight and c[i] the best cross/base contribution — a single
    ``np.maximum.accumulate``.  Cross contributions are a vectorized
    segment-max.  Iterating the two to fixpoint needs only as many rounds
    as the longest cross-edge chain (module hops), not the graph diameter —
    the decisive speedup for incremental re-simulation on deep pipelines.

    chains: list of node-id arrays in chain order; seq_w[i]: SEQ weight into
    node i (0 for chain heads); base[i]: source contribution.
    """
    n = len(base)
    NEGI = np.int64(-(1 << 60))
    c = base.astype(np.int64).copy()
    # precompute per-chain cumulative weights
    cws = [np.cumsum(seq_w[ch]) for ch in chains]
    t = np.full(n, NEGI, dtype=np.int64)
    iters = max_iters or (n + 2)
    for _ in range(iters):
        for ch, cw in zip(chains, cws):
            t[ch] = cw + np.maximum.accumulate(c[ch] - cw)
        if len(cross_dst):
            cand = t[cross_src] + cross_w
            c_new = c.copy()
            np.maximum.at(c_new, cross_dst, cand)
        else:
            c_new = c
        if np.array_equal(c_new, c):
            break
        c = c_new
    else:
        raise ValueError("longest_path_chains did not converge (cycle?)")
    return t


def longest_path_chains_batched(chain_slices, cw, base, cross_dst, cross_src,
                                cross_w, dyn_dst, dyn_src_idx, dyn_valid,
                                bound: int, max_iters: int = 0):
    """Batched chain-decomposed longest path: K configs in one fixpoint.

    The depth-batched analogue of :func:`longest_path_chains` — node columns
    are permuted chain-major (``chain_slices`` index contiguous column
    ranges), so the per-chain pass is one ``np.maximum.accumulate`` over a
    ``(K, len)`` contiguous view per chain, for ALL K configs at once.

    Cross edges split into two groups:

      * static (config-independent, e.g. RAW): ``cross_dst/src/w`` — 1-D
        arrays shared across the batch;
      * dynamic (config-dependent, e.g. regenerated WAR): ``dyn_dst`` (m,)
        destination columns with per-config gather indices ``dyn_src_idx``
        (K, m) and mask ``dyn_valid`` (K, m); weight is 1 (FIFO hold time).

    Destination columns must be UNIQUE within and across the two groups
    (each read node has exactly one RAW in-edge, each write node at most one
    WAR in-edge per config), so the scatter-max is a plain fancy-indexed
    ``np.maximum`` — no ``np.maximum.at`` buffering.

    ``base`` is the (K, n) initial contribution matrix (consumed in place).
    Rows converge independently: converged rows are retired from the working
    set each round, so one pathological config (a WAR cycle grows its times
    past ``bound``) does not tax the others.  Returns ``(times, converged,
    rounds)`` — times (K, n); ``converged[k]`` False means config k's
    regenerated edges formed a cycle (times for that row are meaningless).
    """
    K, n = base.shape
    times = np.empty_like(base)
    converged = np.zeros(K, dtype=bool)
    if n == 0 or K == 0:
        converged[:] = True
        return times, converged, 0
    iters = max_iters or (n + 2)
    act = np.arange(K)                      # rows still iterating
    c = base                                # (K_act, n) working contributions
    t = np.empty_like(c)
    have_dyn = len(dyn_dst) > 0
    dyn_src_act = dyn_src_idx if have_dyn else None
    dyn_valid_act = dyn_valid if have_dyn else None
    rounds = 0
    while len(act):
        rounds += 1
        # ---- chain pass: t = cw + cummax(c - cw) per contiguous chain ----
        for (lo, hi) in chain_slices:
            seg = c[:, lo:hi] - cw[lo:hi]
            np.maximum.accumulate(seg, axis=1, out=seg)
            seg += cw[lo:hi]
            t[:, lo:hi] = seg
        if rounds > iters:
            break                           # leftover rows: cycle
        # ---- cross pass: unique-dst scatter-max into c ----
        changed = np.zeros(len(act), dtype=bool)
        if len(cross_dst):
            cand = t[:, cross_src] + cross_w
            old = c[:, cross_dst]
            np.maximum(cand, old, out=cand)
            changed |= (cand != old).any(axis=1)
            c[:, cross_dst] = cand
        if have_dyn:
            cand = np.take_along_axis(t, dyn_src_act, axis=1)
            cand += 1
            old = c[:, dyn_dst]
            # masked candidates: invalid (w <= S, NB, or no target) entries
            # must not contribute
            cand = np.where(dyn_valid_act, cand, old)
            np.maximum(cand, old, out=cand)
            changed |= (cand != old).any(axis=1)
            c[:, dyn_dst] = cand
        # ---- retire rows: fixpoint reached or blown past the DAG bound ----
        over = (t > bound).any(axis=1)      # positive cycle: early exit
        done = ~changed | over
        if done.any():
            rows = act[done]
            times[rows] = t[done]
            converged[rows] = ~over[done]
            keep = ~done
            act = act[keep]
            c = c[keep]
            t = t[keep]
            if have_dyn:
                dyn_src_act = dyn_src_act[keep]
                dyn_valid_act = dyn_valid_act[keep]
    if len(act):                            # hit the iteration cap: cycles
        times[act] = t
    return times, converged, rounds


class ChainFlatArrays(NamedTuple):
    """Flat chain-major export of the batched solver's graph view.

    The device transfer format of the sparse CUDA fixpoint
    (``repro_torch.kernels.maxplus.sparse``): the argument list of
    :func:`longest_path_chains_batched` as flat ``int32`` arrays.  Node
    columns are chain-major, so chain ``c`` owns the contiguous columns
    ``chain_lo[c] .. chain_hi[c]``.

    Unlike the reference's TPU transfer format, nothing is padded: the
    node axis is not rounded up to 128 lanes and the edge and WAR tables
    are not bucketed to powers of two (a CUDA kernel takes its sizes at
    run time), so every entry is real and every destination column is
    unique.  The segment table (``seg_*``, :func:`segment_table`) cuts
    every chain into runs of at most :func:`segment_length` nodes, the
    unit of parallel work of the kernel's chain pass.

    The WAR tables are the *config-independent* half of WAR regeneration:
    one row per blocking write of every FIFO that has at least one read
    (a blocking overflow with no reads is a structural deadlock, masked
    before solving).  The config-dependent half — which read each write
    waits on under depth ``S`` (``tgt = wseq - S - 1``) — is computed
    on the device from these tables plus the depth block.
    """

    n: int                    # node count
    cw: np.ndarray            # (n,) cumulative SEQ weights along each chain
    chain_lo: np.ndarray      # (C,) first column of each chain
    chain_hi: np.ndarray      # (C,) one past its last column
    c_seed: np.ndarray        # (n,) seed contribution (clipped at -INF)
    raw_dst: np.ndarray       # (E,) static RAW edges, chain-major columns
    raw_src: np.ndarray       # (E,)
    raw_w: np.ndarray         # (E,)
    war_dst: np.ndarray       # (m,) blocking-write columns (unique)
    war_wseq: np.ndarray      # (m,) 1-based write sequence numbers
    war_fid: np.ndarray       # (m,) owning FIFO (column of the depth row)
    war_nr: np.ndarray        # (m,) reads of that FIFO
    war_roff: np.ndarray      # (m,) offset of that FIFO's reads in war_rcols
    war_rcols: np.ndarray     # (R,) concatenated read columns, FIFO-major
    bound: int                # upper bound on any acyclic path length
    seg_lo: np.ndarray        # (G,) first column of each chain segment
    seg_hi: np.ndarray        # (G,) one past its last column
    seg_first: np.ndarray     # (G,) index of its chain's first segment


def segment_length(chain_lens) -> int:
    """Nodes per segment of the sparse kernel's chain pass.

    The kernel runs one thread per (segment, config): a thread reads the
    maxima of the earlier segments of its chain (about ``len / (2 L)``
    words) and then walks its own ``L`` nodes, so ``L = sqrt(len / 2)``
    of the longest chain minimises the longest thread's work; rounded to
    a multiple of 8 (the walk's unroll), at least 16.
    """
    longest = int(np.max(chain_lens)) if len(chain_lens) else 0
    return max(16, 8 * int(round(np.sqrt(longest / 2) / 8)))


def segment_table(chain_lo, chain_hi, seg_len: int):
    """Cut every chain ``chain_lo[c] .. chain_hi[c]`` into segments of at
    most ``seg_len`` nodes, in chain order.  Returns int32 arrays
    ``(seg_lo, seg_hi, seg_first)``: each segment's column range and the
    index of the first segment of its chain.  Every column of every chain
    lies in exactly one segment, and no segment crosses a chain boundary;
    an empty chain has no segment."""
    lo = np.asarray(chain_lo, np.int64)
    hi = np.asarray(chain_hi, np.int64)
    if seg_len < 1:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    count = (hi - lo + seg_len - 1) // seg_len
    first = np.cumsum(count) - count
    chain = np.repeat(np.arange(len(lo)), count)
    seg_lo = lo[chain] + (np.arange(len(chain)) - first[chain]) * seg_len
    seg_hi = np.minimum(seg_lo + seg_len, hi[chain])
    return tuple(np.ascontiguousarray(a, dtype=np.int32)
                 for a in (seg_lo, seg_hi, first[chain]))


def export_chain_flat(chain_slices, cw, c_seed, raw_dst, raw_src, raw_w,
                      fifo_w_cols, fifo_r_cols, fifo_blocking, bound: int,
                      neg: int) -> ChainFlatArrays:
    """Build the :class:`ChainFlatArrays` transfer view of a chain-major
    graph (``neg`` is the int32 -INF sentinel everything is clipped to)."""
    n = len(cw)
    wd, ws, wf, wnr, wro, rc = [], [], [], [], [], []
    roff = 0
    for fid, wcols in enumerate(fifo_w_cols):
        rcols = fifo_r_cols[fid]
        blk = fifo_blocking[fid]
        if len(wcols) == 0 or len(rcols) == 0 or not blk.any():
            continue
        keep = np.flatnonzero(blk)             # only blocking writes can WAR
        wd.append(wcols[keep])
        ws.append(keep + 1)                    # 1-based write sequence
        wf.append(np.full(len(keep), fid, np.int64))
        wnr.append(np.full(len(keep), len(rcols), np.int64))
        wro.append(np.full(len(keep), roff, np.int64))
        rc.append(rcols)
        roff += len(rcols)

    def i32(a):
        return np.ascontiguousarray(np.asarray(a), dtype=np.int32)

    def cat(parts):
        return i32(np.concatenate(parts)) if parts else np.zeros(0, np.int32)

    chain_lo = i32([lo for (lo, _) in chain_slices])
    chain_hi = i32([hi for (_, hi) in chain_slices])
    seg_lo, seg_hi, seg_first = segment_table(
        chain_lo, chain_hi, segment_length(chain_hi - chain_lo))
    return ChainFlatArrays(
        n=n, cw=i32(np.minimum(cw, np.iinfo(np.int32).max)),
        chain_lo=chain_lo, chain_hi=chain_hi,
        c_seed=i32(np.maximum(c_seed, neg)),
        raw_dst=i32(raw_dst), raw_src=i32(raw_src),
        raw_w=i32(np.maximum(raw_w, neg)),
        war_dst=cat(wd), war_wseq=cat(ws), war_fid=cat(wf), war_nr=cat(wnr),
        war_roff=cat(wro), war_rcols=cat(rc), bound=int(bound),
        seg_lo=seg_lo, seg_hi=seg_hi, seg_first=seg_first)


def to_dense_blocks(indptr: np.ndarray, src: np.ndarray, wgt: np.ndarray,
                    base: np.ndarray):
    """Dense max-plus adjacency for the dense sweep kernel (small graphs).

    Returns (A, b) with A[i, j] = weight of edge j->i or -INF (int64
    -2^40; callers clip it to their int32 sentinel).  Unlike the
    reference, nothing is padded to the TPU's 128-wide tiles: the CUDA
    kernel takes any size.
    """
    n = len(base)
    NEG = np.int64(-(1 << 40))
    A = np.full((n, n), NEG, dtype=np.int64)
    b = np.asarray(base, dtype=np.int64).copy()
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        for k in range(lo, hi):
            A[i, src[k]] = max(A[i, src[k]], wgt[k])
    return A, b
