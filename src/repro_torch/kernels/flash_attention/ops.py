"""Model-facing flash attention on ``[B, S, H, hd]`` tensors.

The port of the reference's ``repro.kernels.flash_attention.ops
.flash_attention``: moves heads to the front, calls the head-major kernel
wrapper :func:`~.kernel.flash_attention_bhsd` (the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor) and moves them back.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, Hkv, hd] -> [B, S, H, hd]."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    # contiguous: at B = 1 the reshapes are views with the transposes'
    # strides, and the kernel takes dense rows
    qb = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    kb = k.transpose(1, 2).reshape(B * Hkv, S, hd).contiguous()
    vb = v.transpose(1, 2).reshape(B * Hkv, S, hd).contiguous()
    # a rank of a sharded model may hold no heads (H = Hkv = 0)
    out = flash_attention_bhsd(qb, kb, vb, causal=causal, window=window,
                               softcap=softcap,
                               group_size=H // Hkv if Hkv else 1)
    return out.reshape(B, H, S, hd).transpose(1, 2)
