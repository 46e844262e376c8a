"""The causal depthwise convolution shared by the SSM-style blocks.

Only ``_causal_conv`` of the reference's ``repro.models.ssm`` is ported so
far: xlstm's mLSTM block uses it.  The Mamba-2 (SSD) block of hymba
(``init_ssm``, ``ssm_forward``, ``ssd_scan``, its decode step) belongs to
the hybrid family, a later slice (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D]; w: [K, D] depthwise causal conv, summed tap by tap in
    the reference's order."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + x.shape[1], :] * w[k][None, None, :]
    return out
