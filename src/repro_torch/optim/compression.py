"""Error-feedback int8 gradient compression (1-bit-Adam-style residuals).

The port of ``repro.optim.compression``: each leaf is quantized to int8
with one scale over the whole tensor (its absolute maximum over 127,
rounded half to even), and the quantization error is carried in a float32
residual to be added back next step.  On one card there is no
all-reduce to shrink; the train step applies it under
``grad_compression`` as the reference does (within one step, residual
from zero), so the numbers match.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import tree_field, tree_map


@torch.no_grad()
def init_residuals(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _compress_leaf(g: torch.Tensor, r: torch.Tensor):
    g32 = g.float() + r
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale


@torch.no_grad()
def compress(grads, residuals) -> Tuple[Any, Any, Any]:
    """Returns (int8 grads, scales, new residuals)."""
    out = tree_map(_compress_leaf, grads, residuals)
    return tree_field(out, 0), tree_field(out, 1), tree_field(out, 2)


@torch.no_grad()
def decompress(qs, scales):
    return tree_map(lambda q, s: q.float() * s, qs, scales)
