"""Gated MLP (SwiGLU) feed-forward block.

The port of the reference's ``repro.models.mlp``: weights in its ``[in,
out]`` layout, applied as ``x @ w`` in the compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distrib.sharding import linear
from .common import dense_init, silu, weight


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        self.w_gate = weight((d_model, d_ff), device)
        self.w_up = weight((d_model, d_ff), device)
        self.w_down = weight((d_ff, d_model), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "MLP":
        for w in (self.w_gate, self.w_up, self.w_down):
            w.copy_(dense_init(gen, *w.shape))
        return self


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             device=None) -> MLP:
    return MLP(d_model, d_ff, device=device).reset_parameters(gen)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = silu(linear(x, p.w_gate.to(x.dtype))) * (linear(x, p.w_up.to(x.dtype)))
    return linear(h, p.w_down.to(x.dtype))
