"""Plain PyTorch version of the flash-attention kernel.

The port of the reference's ``repro.kernels.flash_attention.ref
.attention_ref``: exact softmax attention over the whole ``[S, S]`` score
matrix, in f32, in the head-major layout.  The kernel wrapper
(``kernel.flash_attention_bhsd``) calls it only for tensors that lie on
the CPU, which is the CPU tests' path; on the card it is used only to
check the kernel (``chip_smoke.py``).
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  group_size: int = 1) -> torch.Tensor:
    """q: [BH, S, hd]; k, v: [BHkv, S, hd] with BH = BHkv * group_size.

    Row bh of q reads row bh // group_size of k and v.  Scores scaled by
    1/sqrt(hd), then ``softcap * tanh(s / softcap)`` when softcap > 0,
    then masked (key <= query when causal; key > query - window when
    window > 0).  Fully masked rows give 0.  Returns [BH, S, hd] in q's
    dtype.
    """
    BH, S, hd = q.shape
    k = k.repeat_interleave(group_size, dim=0)
    v = v.repeat_interleave(group_size, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # fully masked rows
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
