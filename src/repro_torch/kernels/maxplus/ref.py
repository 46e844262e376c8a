"""Plain PyTorch versions of the two max-plus kernels.

Each function computes exactly what its CUDA kernel computes, with torch
ops on any device.  The kernel wrappers (``sparse.solve_chains``,
``kernel.maxplus_sweep``) call these only for tensors that lie on the CPU,
which is the CPU tests' path; on the card they are used only to check the
kernels (``chip_smoke.py``).  Integer arithmetic throughout, so a kernel
and its plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch


# ---------------------------------------------------------------------------
# kernel 1: the sparse chain-structured fixpoint
# ---------------------------------------------------------------------------
def segmented_cummax_ref(x: torch.Tensor, chain_lo, chain_hi) -> torch.Tensor:
    """Inclusive running max down axis 0 of the node-major ``(n, K)``
    matrix ``x``, restarted at every chain: one ``torch.cummax`` per chain
    ``chain_lo[c] .. chain_hi[c]``."""
    out = torch.empty_like(x)
    for lo, hi in zip(chain_lo.tolist(), chain_hi.tolist()):
        out[lo:hi] = torch.cummax(x[lo:hi], dim=0).values
    return out


def segment_cummax_ref(x: torch.Tensor, seg_lo, seg_hi,
                       seg_first) -> torch.Tensor:
    """:func:`segmented_cummax_ref` as the kernel's chain pass computes it,
    over a segment table (``core.graph.segment_table``): each segment's max
    of ``x`` (pass 1), then each segment's walk from the max of the earlier
    segments of its chain (pass 2).  Equal to :func:`segmented_cummax_ref`
    over the chains the table cuts."""
    out = torch.empty_like(x)
    bounds = list(zip(seg_lo.tolist(), seg_hi.tolist()))
    if not bounds:
        return out
    segmax = torch.stack([x[lo:hi].amax(dim=0) for lo, hi in bounds])
    floor = torch.full_like(x[0], torch.iinfo(x.dtype).min)
    for s, ((lo, hi), first) in enumerate(zip(bounds, seg_first.tolist())):
        carry = segmax[first:s].amax(dim=0) if s > first else floor
        out[lo:hi] = torch.cummax(x[lo:hi], dim=0).values.maximum(carry)
    return out


def solve_chains_ref(arr, depth: torch.Tensor):
    """The sparse fixpoint in torch ops: the Jacobi rounds of the
    reference's ``sparse._fixpoint``, node-major.

    ``arr``: a :class:`~repro_torch.core.graph.ChainFlatArrays` whose
    arrays are int32 tensors on ``depth``'s device; ``depth``: (K, F)
    int32 depth block.  Returns ``(times (n, K) int32, converged (K,)
    bool, rounds)``.  Each round: chain pass ``t = cw + segcummax(c - cw)``;
    rows with a time past ``bound`` are frozen as diverged; then the RAW
    and regenerated WAR scatter-max into ``c`` (destinations are unique,
    so plain indexed assignment is exact).  Stops when no row changes or
    after ``n + 2`` rounds; a row still changing then is not converged.
    """
    n, K = arr.n, depth.shape[0]
    dev = depth.device
    cw = arr.cw[:, None]
    c = arr.c_seed[:, None].expand(n, K).clone()
    t = c.clone()
    raw_dst, raw_src = arr.raw_dst.long(), arr.raw_src.long()
    have_war = arr.war_dst.shape[0] > 0
    if have_war:
        war_dst = arr.war_dst.long()
        S = depth[:, arr.war_fid.long()].T                         # (m, K)
        tgt = arr.war_wseq[:, None] - S - 1
        nr = arr.war_nr[:, None]
        war_valid = (tgt >= 0) & (tgt < nr)
        war_src = arr.war_rcols.long()[
            (arr.war_roff[:, None]
             + torch.minimum(torch.clamp(tgt, min=0), nr - 1)).long()]
    diverged = torch.zeros(K, dtype=torch.bool, device=dev)
    pending = torch.ones(K, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < n + 2 and bool(pending.any()):
        t = segmented_cummax_ref(c - cw, arr.chain_lo, arr.chain_hi) + cw
        diverged |= (t > arr.bound).any(dim=0)
        c2 = c.clone()
        if raw_dst.shape[0]:
            cand = t[raw_src] + arr.raw_w[:, None]
            c2[raw_dst] = torch.maximum(c2[raw_dst], cand)
        if have_war:
            old = c2[war_dst]
            cand = torch.where(war_valid, torch.gather(t, 0, war_src) + 1, old)
            c2[war_dst] = torch.maximum(old, cand)
        c2 = torch.where(diverged[None, :], c, c2)   # freeze cyclic rows
        pending = (c2 != c).any(dim=0) & ~diverged
        c = c2
        rounds += 1
    return t, ~(diverged | pending), rounds


# ---------------------------------------------------------------------------
# kernel 2: the dense sweep
# ---------------------------------------------------------------------------
def maxplus_sweep_ref(a: torch.Tensor, t: torch.Tensor, base: torch.Tensor,
                      any_changed: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``t'[.., i] = max(base[.., i], max_j a[.., i, j] + t[.., j])``;
    ``a`` is ``(N, N)`` or a ``(K, N, N)`` batch, ``t`` ``(N,)`` or
    ``(K, N)``, ``base`` either shape.  int32 sums wrap, as the kernel's.
    ``any_changed`` (one int32 element), when given, is set to whether
    ``t'`` differs from ``t``, as the kernel sets its flag."""
    out = (a + t[..., None, :]).amax(dim=-1).maximum(base)
    if any_changed is not None:
        any_changed.copy_((out != t).any().reshape(1))
    return out
