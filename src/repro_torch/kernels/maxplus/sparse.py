"""Sparse chain-structured batched max-plus fixpoint (kernel 1).

Replaces the reference's ``repro.kernels.maxplus.sparse``: the Pallas
segmented-cummax kernel (``segmented_cummax``) and the ``_fixpoint`` loop
around it.  The solve runs the chain-decomposed fixpoint of
``core.dse._solve_block_numpy`` / ``core.graph.longest_path_chains_batched``
directly over the chain-major flat arrays (:class:`~repro_torch.core.graph
.ChainFlatArrays`), so a block of K depth configs costs O(K·n + K·edges)
device memory.

One round of the hand-written CUDA kernel (``csrc/maxplus_sparse.cu``)
does, for all K configs at once:

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
is a cycle too.  The host reads one flag word per batch of rounds
(:func:`~repro_torch.kernels._cuda.check_batches`), so it launches up to
31 full rounds past the fixpoint, which change nothing.  The state is
node-major ``(n, K)`` int32 with the configs fastest, the layout
``core.dse`` consumes.

Everything is int32 with -INF = :data:`NEG`; callers refuse graphs whose
path-length bound reaches 2^28 (``core.dse``'s saturation guard), so no
sum overflows.
"""
from __future__ import annotations

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


@obs.traced("kernel1.fixpoint")
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
    if depth.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no max-plus kernel for device {depth.device}")
    _check(arr, depth)
    K, n = depth.shape[0], arr.n
    if K == 0 or n == 0:
        return (torch.zeros((n, K), dtype=torch.int32, device=depth.device),
                torch.ones(K, dtype=torch.bool, device=depth.device), 0)
    if depth.device.type == "cpu":
        return solve_chains_ref(arr, depth)
    return _solve_chains_cuda(arr, depth)


def _solve_chains_cuda(arr: ChainFlatArrays, depth: torch.Tensor):
    dev = depth.device
    K, n = depth.shape[0], arr.n
    c = arr.c_seed[:, None].expand(n, K).contiguous()
    t = torch.empty_like(c)             # the first round's walk writes all
    depth_t = depth.t().contiguous()                    # (F, K)
    diverged = torch.zeros(K, dtype=torch.int32, device=dev)
    changed = torch.zeros(K, dtype=torch.int32, device=dev)
    any_changed = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = stream_of(depth)
    E, m = arr.raw_dst.shape[0], arr.war_dst.shape[0]
    nseg = arr.seg_lo.shape[0]
    segmax = torch.empty((nseg, K), dtype=torch.int32, device=dev)
    rounds = 0
    for batch in check_batches(n + 2):
        for _ in range(batch):
            SPARSE.call(
                "maxplus_sparse_round", c.data_ptr(), t.data_ptr(),
                arr.cw.data_ptr(), arr.seg_lo.data_ptr(),
                arr.seg_hi.data_ptr(), arr.seg_first.data_ptr(), nseg,
                segmax.data_ptr(),
                arr.raw_dst.data_ptr(), arr.raw_src.data_ptr(),
                arr.raw_w.data_ptr(), E,
                arr.war_dst.data_ptr(), arr.war_wseq.data_ptr(),
                arr.war_fid.data_ptr(), arr.war_nr.data_ptr(),
                arr.war_roff.data_ptr(), arr.war_rcols.data_ptr(), m,
                depth_t.data_ptr(), K, int(arr.bound), diverged.data_ptr(),
                changed.data_ptr(), any_changed.data_ptr(), stream)
            SPARSE.count()
            rounds += 1
        if not int(any_changed.item()):
            break
    converged = (diverged == 0) & (changed == 0)
    return t, converged, rounds
