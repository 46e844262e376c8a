"""Incremental re-simulation on FIFO-depth changes (paper Sec. 7.2).

PyTorch-port copy of ``repro.core.incremental`` (host logic, numpy); the
batched re-solve that runs on the device is ``core/dse.py``.

Unlike the decoupled baseline — whose simulation graph is depth-independent
for Type A designs — the OmniSim graph is built *under* specific depths, so
reuse must be validated.  The paper's mechanism, reproduced here:

  1. strip the depth-dependent write-after-read (WAR) edges and regenerate
     them from the FIFO tables for the new depths;
  2. re-run Finalization (longest path) to get new node times;
  3. re-evaluate every stored *constraint* (the recorded outcome of each NB
     query / status probe, Table 2 semantics) against the new times;
  4. all constraints hold → the graph is reusable: report the new cycle
     count in microseconds;  any constraint flips → control/data flow would
     diverge → a full re-simulation is required.

Infeasibility is also detected structurally: a committed blocking write
whose (w - S')-th target read never occurred can never commit under the new
depths (deadlock), and regenerated WAR edges that create a cycle mean the
old event order cannot be replayed; both force a full re-sim.

The engine-side compiled-graph cache (:class:`CompiledGraph`, built once by
:func:`compile_graph` and stored on the engine) is the analogue of
LightningSimV2's compile-once/re-solve-many design: every later
``resimulate``/``resimulate_batch`` call over the same base run shares it —
only the WAR regeneration and the fixpoint depend on the candidate depths.
:func:`compiled_graph_from_arrays` rebuilds one from plain arrays, e.g.
the fields of a reference-built graph.

Units: all times are hardware cycles; ``elapsed_s`` fields are wall-clock
seconds; sequence numbers are 1-based per-FIFO event counts (Table 2).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import OmniSim, SEQ, WAR, simulate
from .events import RequestType
from .graph import longest_path_chains
from .program import SimResult

NEGI = np.int64(-(1 << 60))


@dataclass
class IncrementalOutcome:
    """Verdict of one :func:`resimulate` call (paper Sec. 7.2 / Table 6).

    ``ok`` means every recorded constraint held under the new depths and
    the graph was reused; otherwise ``reason`` explains the violation and
    ``result`` is the fallback full re-simulation (or None with
    ``fallback=False``).  ``elapsed_s`` is wall-clock seconds.
    """

    ok: bool                       # constraints satisfied → graph reused
    reason: str
    elapsed_s: float
    result: Optional[SimResult]    # reused (ok) or fallback result
    violated: int = 0              # number of flipped constraint outcomes


@dataclass
class CompiledGraph:
    """Depth-independent numpy snapshot of a finished OmniSim run.

    Holds the base (SEQ + RAW) edge structure in chain-decomposed form,
    per-FIFO committed-event arrays, and the recorded constraint outcomes —
    everything incremental and batched re-simulation need, so repeated calls
    never touch the Python-object graph again.  ``batch`` is the lazily
    built chain-major-permuted view used by ``core/dse.py``.
    """

    n: int
    raw_dst: np.ndarray            # RAW cross edges (depth-independent)
    raw_src: np.ndarray
    raw_w: np.ndarray
    base: np.ndarray               # source contribution (NEGI = none)
    chains: List[np.ndarray]       # per-module node id sequences
    seq_w: np.ndarray              # SEQ weight into each node (0 at heads)
    fifos: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    # ^ per FIFO: (write nodes, read nodes, blocking-write mask)
    c_kind: np.ndarray             # 0 = can-read, 1 = can-write
    c_fifo: np.ndarray
    c_seq: np.ndarray
    c_src: np.ndarray
    c_out: np.ndarray
    batch: Any = field(default=None, repr=False)   # built by core/dse.py


def compile_graph(engine: OmniSim) -> CompiledGraph:
    """Build (once) and return the engine's compiled-graph cache.

    Chain decomposition: per-module node sequences (SEQ edges) plus
    cross-module RAW edges; WAR edges are depth-dependent and regenerated
    per candidate depth vector.  Subsequent incremental/batched calls are
    fully vectorized against these arrays (the engine-side analogue of
    LightningSimV2's compiled-graph reuse).
    """
    cached = getattr(engine, "_incr_cache", None)
    if cached is not None:
        return cached
    nodes = engine.graph.nodes
    n = len(nodes)
    dsts, srcs, wgts = [], [], []
    base_c = np.full(n, NEGI, dtype=np.int64)
    seq_w = np.zeros(n, dtype=np.int64)
    chains_map: Dict[int, List[int]] = {}
    for node in nodes:
        chains_map.setdefault(node.module, []).append(node.idx)
        if not node.preds:
            base_c[node.idx] = node.time
        for (s, w) in node.preds:
            kind = engine._edge_kinds.get((node.idx, s), SEQ)
            if kind == WAR:
                continue
            if kind == SEQ:
                seq_w[node.idx] = w
                continue
            dsts.append(node.idx)       # RAW cross edge
            srcs.append(s)
            wgts.append(w)
    chains = [np.asarray(v, np.int64) for v in chains_map.values()]
    # NB-committed writes never stall: regenerated WAR edges must attach
    # only to blocking writes (NB depth-dependence is a CONSTRAINT).
    nb_write_nodes = {
        int(c.source_node) for c in engine.constraints
        if c.rtype in (RequestType.FIFO_NB_WRITE, RequestType.FIFO_CAN_WRITE)
        and c.outcome}
    fifo_np = []
    for tbl in engine.fifos:
        w_nodes = np.asarray(tbl.writes, np.int64).copy()
        blocking = np.asarray([int(w) not in nb_write_nodes
                               for w in w_nodes], bool)
        fifo_np.append((w_nodes, np.asarray(tbl.reads, np.int64).copy(),
                        blocking))
    # constraint arrays: kind 0 = can-read (target = seq-th write),
    # kind 1 = can-write (target depends on depth)
    c_kind, c_fifo, c_seq, c_src, c_out = [], [], [], [], []
    for c in engine.constraints:
        is_read = c.rtype in (RequestType.FIFO_NB_READ,
                              RequestType.FIFO_CAN_READ)
        c_kind.append(0 if is_read else 1)
        c_fifo.append(c.fifo)
        c_seq.append(c.source_seq)
        c_src.append(c.source_node)
        c_out.append(c.outcome)
    cg = CompiledGraph(
        n=n,
        raw_dst=np.asarray(dsts, np.int64),
        raw_src=np.asarray(srcs, np.int64),
        raw_w=np.asarray(wgts, np.int64),
        base=base_c,
        chains=chains,
        seq_w=seq_w,
        fifos=fifo_np,
        c_kind=np.asarray(c_kind, np.int64),
        c_fifo=np.asarray(c_fifo, np.int64),
        c_seq=np.asarray(c_seq, np.int64),
        c_src=np.asarray(c_src, np.int64),
        c_out=np.asarray(c_out, bool),
    )
    engine._incr_cache = cg
    return cg


#: the array fields :func:`compiled_graph_from_arrays` reads
GRAPH_FIELDS = ("n", "raw_dst", "raw_src", "raw_w", "base", "chains",
                "seq_w", "fifos", "c_kind", "c_fifo", "c_seq", "c_src",
                "c_out")


def compiled_graph_from_arrays(fields: Dict[str, Any]) -> CompiledGraph:
    """Build a :class:`CompiledGraph` from plain numpy arrays and lists.

    ``fields`` maps every name of :data:`GRAPH_FIELDS` to the value of the
    same :class:`CompiledGraph` field: ``chains`` a list of node-id
    arrays, ``fifos`` a list of ``(write nodes, read nodes, blocking
    mask)`` triples, the rest arrays.  Any object with those fields
    converted to numpy works — in particular a ``repro.core.incremental
    .CompiledGraph`` built by the reference, which lets the port's solvers
    run on reference-built graphs.  Arrays are copied; the batched view is
    built lazily on first use, as for :func:`compile_graph`.
    """
    missing = [k for k in GRAPH_FIELDS if k not in fields]
    if missing:
        raise ValueError(f"compiled graph fields missing: {missing}")

    def i64(a):
        return np.array(a, dtype=np.int64).reshape(-1)

    return CompiledGraph(
        n=int(fields["n"]),
        raw_dst=i64(fields["raw_dst"]), raw_src=i64(fields["raw_src"]),
        raw_w=i64(fields["raw_w"]), base=i64(fields["base"]),
        chains=[i64(ch) for ch in fields["chains"]],
        seq_w=i64(fields["seq_w"]),
        fifos=[(i64(w), i64(r), np.array(b, dtype=bool).reshape(-1))
               for (w, r, b) in fields["fifos"]],
        c_kind=i64(fields["c_kind"]), c_fifo=i64(fields["c_fifo"]),
        c_seq=i64(fields["c_seq"]), c_src=i64(fields["c_src"]),
        c_out=np.array(fields["c_out"], dtype=bool).reshape(-1))


def _cross_edges(engine: OmniSim, depths: Sequence[int]):
    """RAW cross edges (cached) + WAR edges regenerated for ``depths`` —
    fully vectorized."""
    cache = compile_graph(engine)
    dst_parts = [cache.raw_dst]
    src_parts = [cache.raw_src]
    wgt_parts = [cache.raw_w]
    for tbl, (w_nodes, r_nodes, blocking) in zip(engine.fifos, cache.fifos):
        S = depths[tbl.fid]
        nw = len(w_nodes)
        if nw <= S:
            continue
        w_seq = np.arange(S + 1, nw + 1, dtype=np.int64)      # writes > S
        tgt = w_seq - S - 1
        blk = blocking[S:]
        # a BLOCKING write whose target read never happened can never
        # commit (deadlock); an NB write in that situation simply fails —
        # which its constraint re-evaluation reports as a flip.
        if np.any(blk & (tgt >= len(r_nodes))):
            bad = int(w_seq[blk & (tgt >= len(r_nodes))][0])
            return None, None, None, (
                f"write #{bad} on '{tbl.name}' can never commit with "
                f"depth {S} (would deadlock)")
        sel = blk & (tgt < len(r_nodes))
        dst_parts.append(w_nodes[S:][sel])
        src_parts.append(r_nodes[tgt[sel]])
        wgt_parts.append(np.ones(int(sel.sum()), np.int64))
    return (np.concatenate(dst_parts), np.concatenate(src_parts),
            np.concatenate(wgt_parts), None)


def check_constraints(cache: CompiledGraph, times: np.ndarray,
                      depths: Sequence[int]) -> int:
    """Re-evaluate every stored constraint against ``times`` (paper
    Sec. 7.2); returns the number of flipped outcomes."""
    if not len(cache.c_kind):
        return 0
    new_ok = np.zeros(len(cache.c_kind), bool)
    src_t = times[cache.c_src]
    for fid, (w_nodes, r_nodes, _blk) in enumerate(cache.fifos):
        S = depths[fid]
        sel = cache.c_fifo == fid
        if not sel.any():
            continue
        seq = cache.c_seq[sel]
        kind = cache.c_kind[sel]
        st = src_t[sel]
        ok = np.zeros(len(seq), bool)
        # reads: target = seq-th write
        rd = kind == 0
        tgt = np.minimum(seq[rd] - 1, max(len(w_nodes) - 1, 0))
        exists = (seq[rd] - 1) < len(w_nodes)
        t_tgt = times[w_nodes[tgt]] if len(w_nodes) else \
            np.zeros(len(tgt), np.int64)
        ok[rd] = exists & (t_tgt < st[rd])
        # writes: trivially true if seq <= S, else target read
        wr = kind == 1
        seq_w = seq[wr]
        triv = seq_w <= S
        tgt_w = np.clip(seq_w - S - 1, 0, max(len(r_nodes) - 1, 0))
        exists_w = (seq_w - S - 1) < len(r_nodes)
        t_tgt_w = times[r_nodes[tgt_w]] if len(r_nodes) else \
            np.zeros(len(tgt_w), np.int64)
        ok[wr] = triv | (exists_w & (t_tgt_w < st[wr]))
        new_ok[sel] = ok
    return int((new_ok != cache.c_out).sum())


def verify_times(graph: CompiledGraph, times: np.ndarray,
                 depths: Sequence[int]) -> Optional[str]:
    """Pointwise max-plus + Table-2 re-verification of a claimed solution.

    The reference's whole-run replay verifier, lifted to a
    :class:`CompiledGraph`: re-derive every node's contribution vector
    (base + RAW + WAR regenerated for ``depths``) and check that ``times``
    satisfies the chain recurrence ``t[i] == max(t[i-1] + seq_w[i], c[i])``
    *pointwise*, then re-evaluate every stored Table-2 constraint outcome.
    The dependency graph of a completed run is acyclic, so pointwise
    equality pins the unique fixpoint — a verified solution IS the
    solution, no matter how it was produced.

    Returns ``None`` when verified, else a human-readable reason.
    """
    n = graph.n
    times = np.asarray(times, dtype=np.int64)
    if len(times) != n:
        return f"times length {len(times)} != graph nodes {n}"
    c = graph.base.astype(np.int64, copy=True)
    if len(graph.raw_dst):
        np.maximum.at(c, graph.raw_dst, times[graph.raw_src] + graph.raw_w)
    for fid, (w_nodes, r_nodes, blocking) in enumerate(graph.fifos):
        S = int(depths[fid])
        nw = len(w_nodes)
        if nw <= S:
            continue
        tgt = np.arange(nw - S, dtype=np.int64)          # writes > S
        blk = blocking[S:]
        if np.any(blk & (tgt >= len(r_nodes))):
            return (f"blocking write beyond depth {S} of FIFO {fid} has no "
                    f"matching read (structural deadlock)")
        sel = blk & (tgt < len(r_nodes))
        np.maximum.at(c, w_nodes[S:][sel], times[r_nodes[tgt[sel]]] + 1)
    prev = np.full(n, NEGI, dtype=np.int64)
    for ch in graph.chains:
        if len(ch) > 1:
            prev[ch[1:]] = times[ch[:-1]]
    expect = np.maximum(np.where(prev == NEGI, NEGI, prev + graph.seq_w), c)
    if not np.array_equal(expect, times):
        bad = int(np.flatnonzero(expect != times)[0])
        return (f"pointwise max-plus mismatch at node {bad}: "
                f"expected {int(expect[bad])}, claimed {int(times[bad])}")
    flips = check_constraints(graph, times, depths)
    if flips:
        return f"{flips} Table-2 constraint outcome(s) flipped"
    return None


def resimulate(result: SimResult, new_depths: Sequence[int],
               fallback: bool = True) -> IncrementalOutcome:
    """Attempt incremental re-simulation of an OmniSim result.

    With ``fallback=True`` a constraint violation triggers a full re-sim
    (reusing the compiled program — the paper's Table 6 second row).
    """
    t0 = _time.perf_counter()
    engine: OmniSim = result.graph
    assert isinstance(engine, OmniSim), "incremental re-sim needs an OmniSim result"
    new_depths = tuple(int(d) for d in new_depths)

    cache = compile_graph(engine)
    cross_dst, cross_src, cross_w, err = _cross_edges(engine, new_depths)
    if err is None:
        try:
            times = longest_path_chains(cache.chains, cache.seq_w,
                                        cache.base, cross_dst, cross_src,
                                        cross_w)
        except ValueError:           # WAR edges formed a cycle
            err = "regenerated WAR edges create a cycle (event order invalid)"
    if err is None:
        # re-evaluate constraints (paper Sec. 7.2) — vectorized
        violated = check_constraints(cache, times, new_depths)
        if violated == 0:
            cycles = int(times.max()) if len(times) else 0
            elapsed = _time.perf_counter() - t0
            new_res = SimResult(program=result.program,
                                outputs=dict(result.outputs), cycles=cycles,
                                engine="omnisim-incr", stats=result.stats,
                                graph=engine, constraints=result.constraints,
                                depths=new_depths)
            return IncrementalOutcome(True, "constraints satisfied", elapsed,
                                      new_res)
        err = f"{violated} constraint(s) violated — control/data flow diverges"
    elapsed = _time.perf_counter() - t0
    if not fallback:
        return IncrementalOutcome(False, err, elapsed, None)
    full = simulate(engine.program, depths=new_depths)
    elapsed = _time.perf_counter() - t0
    out = IncrementalOutcome(False, err, elapsed, full)
    return out
