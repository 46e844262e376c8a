"""Model-facing chunked mLSTM on ``[B, S, H, ·]`` tensors.

The port of the reference's ``repro.kernels.mlstm_chunk.ops.mlstm_chunk``:
moves heads to the front, calls the head-major kernel wrapper
:func:`~.kernel.mlstm_chunk_bhsd` (the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor) with ``chunk = min(chunk, S)``, and moves
them back.  A sequence that is not a multiple of the chunk raises, as the
reference asserts.
"""
from __future__ import annotations

import torch

from .kernel import mlstm_chunk_bhsd


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ig: torch.Tensor, la: torch.Tensor, *,
                chunk: int = 128) -> torch.Tensor:
    """q, k: [B, S, H, P]; v: [B, S, H, Pv]; ig, la: [B, S, H].  Returns
    [B, S, H, Pv]."""
    B, S, H, P = q.shape
    Pv = v.shape[-1]
    qb = q.transpose(1, 2).reshape(B * H, S, P)
    kb = k.transpose(1, 2).reshape(B * H, S, P)
    vb = v.transpose(1, 2).reshape(B * H, S, Pv)
    igb = ig.transpose(1, 2).reshape(B * H, S)
    lab = la.transpose(1, 2).reshape(B * H, S)
    out = mlstm_chunk_bhsd(qb, kb, vb, igb, lab, chunk=min(chunk, S))
    return out.reshape(B, H, S, Pv).transpose(1, 2)
