"""Sparse chain-structured batched max-plus fixpoint (kernel 1).

Replaces the reference's ``repro.kernels.maxplus.sparse``: the Pallas
segmented-cummax kernel (``segmented_cummax``) and the ``_fixpoint`` loop
around it.  The solve runs the chain-decomposed fixpoint of
``core.dse._solve_block_numpy`` / ``core.graph.longest_path_chains_batched``
directly over the chain-major flat arrays (:class:`~repro_torch.core.graph
.ChainFlatArrays`), so a block of K depth configs costs O(K·n + K·edges)
device memory.

One round of the hand-written CUDA kernel (``csrc/maxplus_sparse.cu``,
which launches a batch of rounds a call) does, for all K configs of a
block at once:

  1. **chain pass** — ``t = cw + cummax_within_chain(c - cw)``, over the
     segments of the graph's segment table (every chain cut into runs of
     at most :func:`~repro_torch.core.graph.segment_length` nodes): one
     thread per (segment, config) takes its segment's max of ``c - cw``,
     then one per (segment, config) carries the maxima of the earlier
     segments of its chain in and walks its segment (4 configs a thread
     where K is a multiple of 4; the TPU's doubling scan existed for its
     tiles and is not carried over; the plain form of this decomposition
     is :func:`~.ref.segment_cummax_ref`);
  2. **cross pass** — static RAW edges ``c[dst] = max(c[dst], t[src]+w)``
     and the WAR edges regenerated on the device from the depth block
     (write ``wseq`` of FIFO ``f`` under depth ``S`` waits on read
     ``wseq - S - 1``, weight 1): one thread per (edge, config), or per
     (edge, 4 configs), no atomics, because destinations are unique.

A row whose times pass the acyclic ``bound`` is frozen as diverged (a WAR
cycle) before the cross pass of that round.  The loop stops when no row
changed in a round, or after ``n + 2`` rounds; a row still changing then
is a cycle too.  The state is node-major ``(n, K)`` int32 with the configs
fastest, the layout ``core.dse`` consumes.

**The live list.**  Rows are independent, and a row that changed nothing
in a round is at its least fixpoint for good.  So after the last round of
each batch (:func:`~repro_torch.kernels._cuda.check_batches`: after 1, 2,
4, ... 32 rounds) a fourth kernel lists on the device the rows that changed
and have not diverged, and the host reads the list's length, its one sync
per batch: 0 stops the loop, so up to 31 rounds run past the fixpoint.
Where that length is at most half of the rows the rounds cover, the
listed rows' columns are gathered into a block of their own and the next
rounds run on it; the rows left out keep the times and flags of their
last round, written back into the whole block's, so the result is the one
rounds over all K rows give, bit for bit.  A block whose rows need 3 to
7 682 rounds (``matmul_stream``) spends its late rounds on the few rows
still changing, held densely, where the L2 keeps them (``csrc/
maxplus_sparse.cu`` says why they are not solved in place).

Under a profiler each call is recorded as the span ``kernel1.fixpoint``
(:mod:`repro_torch.obs`) with ``rows`` (K), ``rounds`` (launched) and
``row_rounds``: the rows the launched rounds covered, summed over rounds
(the plain version: ``K * rounds``).

Everything is int32 with -INF = :data:`NEG`; callers refuse graphs whose
path-length bound reaches 2^28 (``core.dse``'s saturation guard), so no
sum overflows.
"""
from __future__ import annotations

import time

import torch

from ... import obs
from ...core.graph import ChainFlatArrays
from .._cuda import SPARSE, check_batches, stream_of
from .ref import solve_chains_ref

# int32 -INF sentinel — matches the numpy solver's int32 mode, and leaves
# headroom: with bound < 2^28 (enforced upstream) no max-plus candidate
# t + w can overflow int32 arithmetic.
NEG = -(1 << 29)
_ARRAY_FIELDS = ("cw", "chain_lo", "chain_hi", "c_seed", "raw_dst", "raw_src",
                 "raw_w", "war_dst", "war_wseq", "war_fid", "war_nr",
                 "war_roff", "war_rcols", "seg_lo", "seg_hi", "seg_first")


def to_device(arr: ChainFlatArrays, device) -> ChainFlatArrays:
    """The same arrays as contiguous int32 tensors on ``device``."""
    return arr._replace(**{
        f: torch.as_tensor(getattr(arr, f), dtype=torch.int32).to(device)
        .contiguous() for f in _ARRAY_FIELDS})


def _check(arr: ChainFlatArrays, depth: torch.Tensor) -> None:
    dev = depth.device
    if depth.dtype != torch.int32 or depth.dim() != 2:
        raise ValueError(f"depth block must be (K, F) int32, got "
                         f"{tuple(depth.shape)} {depth.dtype}")
    for f in _ARRAY_FIELDS:
        a = getattr(arr, f)
        if not isinstance(a, torch.Tensor) or a.dtype != torch.int32 \
                or a.device != dev or not a.is_contiguous() or a.dim() != 1:
            raise ValueError(f"ChainFlatArrays.{f} must be a contiguous 1-D "
                             f"int32 tensor on {dev} (see to_device)")
    if arr.cw.shape[0] != arr.n or arr.c_seed.shape[0] != arr.n:
        raise ValueError("cw and c_seed must have one entry per node")
    if not arr.seg_lo.shape[0] == arr.seg_hi.shape[0] \
            == arr.seg_first.shape[0]:
        raise ValueError("the segment table's arrays differ in length")
    if arr.war_fid.shape[0] and int(arr.war_fid.max()) >= depth.shape[1]:
        raise ValueError("depth block has fewer columns than the graph's "
                         "FIFOs")


def solve_chains(arr: ChainFlatArrays, depth: torch.Tensor):
    """Solve K depth configs over one chain-flat graph.

    ``arr``: chain-flat arrays as int32 tensors (:func:`to_device`);
    ``depth``: (K, n_fifos) int32 depth block on the same device.  Returns
    ``(times, converged, rounds)`` — ``times`` (n, K) int32 in chain-major
    node order, ``converged`` (K,) bool, False where config k's
    regenerated WAR edges form a cycle (its times are then meaningless),
    and the number of rounds launched: at least the rounds the fixpoint
    needs, up to and including the first that changes nothing (or the
    ``n + 2`` cap), since the flag is read once per batch of rounds.

    A CUDA tensor runs the hand-written kernel; a CPU tensor runs the plain
    version (:func:`~.ref.solve_chains_ref`); any other device raises.
    """
    t0 = time.perf_counter_ns()
    # the span's attributes, as far as the solve got: a call that raises
    # is recorded too
    tally = {"rows": 0, "rounds": 0, "row_rounds": 0}
    try:
        if depth.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no max-plus kernel for device {depth.device}")
        _check(arr, depth)
        K, n = depth.shape[0], arr.n
        tally["rows"] = K
        if K == 0 or n == 0:
            return (torch.zeros((n, K), dtype=torch.int32,
                                device=depth.device),
                    torch.ones(K, dtype=torch.bool, device=depth.device), 0)
        if depth.device.type == "cpu":
            t, converged, rounds = solve_chains_ref(arr, depth)
            tally.update(rounds=rounds, row_rounds=K * rounds)
            return t, converged, rounds
        return _solve_chains_cuda(arr, depth, tally)
    finally:
        obs.emit("kernel1.fixpoint", t0, time.perf_counter_ns(), **tally)


def _solve_chains_cuda(arr: ChainFlatArrays, depth: torch.Tensor,
                       tally: dict):
    """The round loop on the card: ``(times, converged, rounds)``; adds
    the rounds launched and the rows they covered to ``tally``."""
    dev = depth.device
    K, n = depth.shape[0], arr.n
    c = arr.c_seed[:, None].expand(n, K).contiguous()
    t = torch.empty_like(c)             # the first round's walk writes all
    depth_t = depth.t().contiguous()                    # (F, K)
    diverged = torch.zeros(K, dtype=torch.int32, device=dev)
    changed = torch.zeros(K, dtype=torch.int32, device=dev)
    stream = stream_of(depth)
    nseg = arr.seg_lo.shape[0]
    segmax = torch.empty((nseg, K), dtype=torch.int32, device=dev)
    live = torch.empty(K, dtype=torch.int32, device=dev)
    n_live = torch.zeros(1, dtype=torch.int32, device=dev)
    graph = (arr.cw.data_ptr(), arr.seg_lo.data_ptr(), arr.seg_hi.data_ptr(),
             arr.seg_first.data_ptr(), nseg, segmax.data_ptr(),
             arr.raw_dst.data_ptr(), arr.raw_src.data_ptr(),
             arr.raw_w.data_ptr(), arr.raw_dst.shape[0],
             arr.war_dst.data_ptr(), arr.war_wseq.data_ptr(),
             arr.war_fid.data_ptr(), arr.war_nr.data_ptr(),
             arr.war_roff.data_ptr(), arr.war_rcols.data_ptr(),
             arr.war_dst.shape[0])
    # once the rounds leave rows behind: the whole block's (t, diverged,
    # changed), and the whole block's index of each row still solved
    whole, rows = None, None
    k, key = K, None
    for batch in check_batches(n + 2):
        SPARSE.call("maxplus_sparse_rounds", c.data_ptr(), t.data_ptr(),
                    *graph, depth_t.data_ptr(), k, int(arr.bound),
                    diverged.data_ptr(), changed.data_ptr(), batch, stream)
        SPARSE.count(key=key, n=batch)
        tally["rounds"] += batch
        tally["row_rounds"] += batch * k
        SPARSE.call("maxplus_sparse_live", changed.data_ptr(),
                    diverged.data_ptr(), k, live.data_ptr(),
                    n_live.data_ptr(), stream)
        now = int(n_live.item())
        if not now:
            break
        if 2 * now <= k:
            keep = live[:now].long()
            if whole is None:
                whole, rows = (t, diverged, changed), keep
            else:
                _write_back(whole, rows, t, diverged, changed)
                rows = rows[keep]
            c, t, depth_t = (x.index_select(1, keep) for x in (c, t, depth_t))
            diverged, changed = diverged[keep], changed[keep]
            k, key = now, "live"
    if whole is not None:
        _write_back(whole, rows, t, diverged, changed)
        t, diverged, changed = whole
    converged = (diverged == 0) & (changed == 0)
    return t, converged, tally["rounds"]


def _write_back(whole, rows, t, diverged, changed) -> None:
    """Put the rows of a gathered block back into the whole block's times
    and flags."""
    whole[0][:, rows] = t
    whole[1][rows] = diverged
    whole[2][rows] = changed
