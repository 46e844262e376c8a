"""Dense batched max-plus relaxation sweep (kernel 2).

Replaces the reference's ``repro.kernels.maxplus.kernel.maxplus_sweep``
(a Pallas kernel over 128x128 int32 VMEM tiles).  One launch of the
hand-written CUDA kernel (``csrc/maxplus_dense.cu``) computes

    t'[k, i] = max(base[k, i], max_j A[k, i, j] + t[k, j])

for a whole ``(K, N, N)`` batch: one warp per output row reduces over j,
with ``t[k]`` staged in shared memory.  It moves int32 bytes (A is read
once per sweep) and uses no tensor cores.  ``ops.longest_path`` iterates
it to the fixpoint; ``core.dse``'s ``backend="cuda_dense"`` lane and
``ops.finalize_times`` are its callers.

-INF is :data:`NEG` = -2^30, so -INF + -INF is exactly ``INT32_MIN``:
keep this sentinel apart from the sparse kernel's -2^29, and clip int64
sentinels to it before any int32 cast.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._cuda import DENSE, stream_of
from .ref import maxplus_sweep_ref

NEG = -(1 << 30)


def _check(a: torch.Tensor, t: torch.Tensor, base: torch.Tensor):
    """Validate shapes; returns ``(K, N, base_stride)``."""
    for name, x in (("a", a), ("t", t), ("base", base)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if a.dim() not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"a must be (N, N) or (K, N, N), got {tuple(a.shape)}")
    N = a.shape[-1]
    K = a.shape[0] if a.dim() == 3 else 1
    if tuple(t.shape) != tuple(a.shape[:-1]):
        raise ValueError(f"t must have shape {tuple(a.shape[:-1])}, got "
                         f"{tuple(t.shape)}")
    if tuple(base.shape) == (N,):
        stride = 0
    elif tuple(base.shape) == tuple(t.shape):
        stride = N
    else:
        raise ValueError(f"base must be ({N},) or {tuple(t.shape)}, got "
                         f"{tuple(base.shape)}")
    return K, N, stride


def maxplus_sweep(a: torch.Tensor, t: torch.Tensor, base: torch.Tensor,
                  any_changed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One relaxation sweep ``t' = max(base, a (+) t)``.

    ``a``: (N, N) or (K, N, N) int32, ``a[.., i, j]`` the weight of edge
    j -> i or :data:`NEG`; ``t``: (N,) or (K, N) int32; ``base``: (N,)
    shared or shaped like ``t``.  When ``any_changed`` (one int32 element
    on the same device) is given, it is set to 1 if ``t'`` differs from
    ``t`` anywhere and to 0 otherwise.

    A CUDA tensor runs the hand-written kernel; a CPU tensor runs the plain
    version (:func:`~.ref.maxplus_sweep_ref`); any other device raises.
    """
    K, N, stride = _check(a, t, base)
    if a.device.type == "cpu":
        return maxplus_sweep_ref(a, t, base, any_changed)
    if a.device.type != "cuda":
        raise ValueError(f"no max-plus kernel for device {a.device}")
    if K > 65535:
        raise ValueError(f"at most 65535 configs per sweep, got {K}")
    a, t, base = a.contiguous(), t.contiguous(), base.contiguous()
    flag = any_changed
    if flag is None:
        flag = torch.empty(1, dtype=torch.int32, device=a.device)
    elif (flag.dtype != torch.int32 or flag.device != a.device
          or flag.numel() != 1):
        raise ValueError("any_changed must be one int32 element on "
                         f"{a.device}")
    out = torch.empty_like(t)
    if N and K:
        DENSE.call("maxplus_dense_sweep", a.data_ptr(), t.data_ptr(),
                   base.data_ptr(), stride, out.data_ptr(), N, K,
                   flag.data_ptr(), stream_of(a))
        DENSE.count()
    return out
