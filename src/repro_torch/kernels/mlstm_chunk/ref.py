"""Plain PyTorch version of the chunked mLSTM kernel.

The port of the reference's ``repro.kernels.mlstm_chunk.ref.mlstm_ref``:
the direct O(S^2) recurrence over the whole sequence, in f32, in the
head-major layout.  One difference in order, not in value: the causal mask
is applied before the exp (the reference takes ``exp`` over the whole
``[S, S]`` difference and then discards s > t, where it may overflow to
+inf).  The kernel wrapper (``kernel.mlstm_chunk_bhsd``) calls it only for
tensors that lie on the CPU, which is the CPU tests' path; on the card it
is used only to check the kernel (``chip_smoke.py``).
"""
from __future__ import annotations

import torch


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ig: torch.Tensor, la: torch.Tensor) -> torch.Tensor:
    """q, k: [BH, S, P]; v: [BH, S, Pv]; ig, la: [BH, S].

    y[t] = sum_{s<=t} exp(cum[t] - cum[s]) ig[s] (q[t].k[s]) v[s], with cum
    the cumulative sum of ``la`` over the sequence.  Returns [BH, S, Pv] in
    q's dtype.
    """
    S = q.shape[1]
    cum = torch.cumsum(la.float(), dim=1)                       # [BH, S]
    diff = cum[:, :, None] - cum[:, None, :]                    # [BH, S, S]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))     # 0 for s > t
    scores = torch.einsum("btp,bsp->bts", q.float(), k.float()) * L
    iv = ig.float()[..., None] * v.float()
    return torch.einsum("bts,bsp->btp", scores, iv).to(q.dtype)
