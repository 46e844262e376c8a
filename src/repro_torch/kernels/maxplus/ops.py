"""Dispatchers: fixpoint longest path over dense max-plus matrices.

``longest_path(A, base)`` iterates :func:`~.kernel.maxplus_sweep` until the
time vector stops changing, at most N sweeps (the reference's
``repro.kernels.maxplus.ops.longest_path``).  The "changed" flag stays on
the device; the host reads it once per batch of sweeps
(:func:`~repro_torch.kernels._cuda.check_batches`), so up to 31 full
sweeps past the fixpoint run and change nothing.  ``finalize_times``
re-derives a :class:`~repro_torch.core.graph.SimGraph`'s node times
through it.

Dispatch rule: a CUDA tensor goes to the hand-written kernel (or the call
raises); a CPU tensor goes to the plain PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.graph import to_dense_blocks
from .._cuda import check_batches, resolve_device
from .kernel import NEG, maxplus_sweep


def longest_path(a: torch.Tensor, base: torch.Tensor, *,
                 max_iters: int = 0) -> torch.Tensor:
    """Fixpoint ``t = max(base, A (+) t)`` from ``t = base``.

    ``a``: (N, N) or (K, N, N) int32; ``base``: (N,) int32, shared by the
    batch, or one row per config.  Returns t, (N,) or (K, N) int32.  At
    most ``max_iters`` sweeps (default N); rows still changing then are
    not at a fixpoint, which one more sweep shows (``core.dse`` uses it as
    the convergence certificate).
    """
    n = a.shape[-1]
    t = base.expand(a.shape[:-1]).contiguous()
    flag = torch.zeros(1, dtype=torch.int32, device=a.device)
    for batch in check_batches(max_iters or n):
        for _ in range(batch):
            t = maxplus_sweep(a, t, base, flag)
        if not int(flag.item()):
            break
    return t


def finalize_times(graph, *, device="cuda") -> torch.Tensor:
    """Longest-path node times of a SimGraph via the dense sweep, as an
    int32 tensor on ``device``."""
    device = resolve_device(device)
    indptr, src, wgt, base = graph.to_csr()
    a, b = to_dense_blocks(indptr, src, wgt, base)
    # clip the int64 -INF sentinel in numpy BEFORE the int32 cast —
    # casting -(1<<40) through int32 would wrap to 0 (a phantom edge).
    a32 = torch.from_numpy(np.maximum(a, NEG).astype(np.int32)).to(device)
    b32 = torch.from_numpy(np.maximum(b, NEG).astype(np.int32)).to(device)
    return longest_path(a32, b32)
