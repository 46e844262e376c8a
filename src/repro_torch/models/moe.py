"""Mixture-of-Experts layer: top-k routing over stacked expert weights.

The port of the reference's ``repro.models.moe`` on one device.  Its
``impl="dense"`` path (:func:`moe_dense`) is the masked dense compute:
every padded expert runs on every token, weighted by the routing
weights, with the reference's einsums and casts.  Its ``impl="ep"`` path
(``moe_ep``: ``shard_map`` and all-to-all over a mesh) needs several
devices and is not ported here (ROADMAP queue 1 item 10.7); with no mesh
the reference's :func:`moe` serves every config through ``moe_dense``,
and so does the port's.  Plain torch: the reference has no Pallas kernel
here.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig, MoEConfig
from .common import dense_init, silu, weight
from .mlp import MLP, mlp


def padded_experts(mo: MoEConfig, expert_shards: int = 16) -> int:
    """Experts padded up to a multiple of the expert-shard count, as the
    reference pads them (granite: 40 -> 48; a smoke config: 8 -> 16).  The
    padding experts are never routed to, but their weights exist and
    enter :func:`moe_dense`'s products."""
    E = mo.num_experts
    return -(-E // expert_shards) * expert_shards


class MoE(nn.Module):
    """``router`` [d, E] and stacked expert weights ``w_gate``, ``w_up``
    [E, d, f] and ``w_down`` [E, f, d] (E padded), plus the ``shared``
    MLP when the config has shared experts."""

    def __init__(self, cfg: ArchConfig, expert_shards: int = 16, *,
                 device=None):
        super().__init__()
        mo = cfg.moe
        d, f = cfg.d_model, mo.d_expert
        E = padded_experts(mo, expert_shards)
        self.router = weight((d, E), device)
        self.w_gate = weight((E, d, f), device)
        self.w_up = weight((E, d, f), device)
        self.w_down = weight((E, f, d), device)
        if mo.num_shared_experts:
            self.shared = MLP(d, mo.d_shared or mo.d_expert, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "MoE":
        """``init_moe``'s initializers: each expert's matrices uniform in
        ``1/sqrt(fan_in)``, as the router's."""
        self.router.copy_(dense_init(gen, *self.router.shape))
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                w[e].copy_(dense_init(gen, *w.shape[1:]))
        if hasattr(self, "shared"):
            self.shared.reset_parameters(gen)
        return self


def _route(p: MoE, x: torch.Tensor, mo: MoEConfig):
    """Returns (weights [B,S,K] f32 normalised, idx [B,S,K] int32): f32
    router logits, the padding experts at -1e30, top-k in descending
    order, and a softmax over the k values."""
    logits = x.float() @ p.router.float()
    E = p.router.shape[-1]
    if E > mo.num_experts:      # padding experts can never be routed to
        pad = torch.arange(E, device=x.device) >= mo.num_experts
        logits = logits.masked_fill(pad, -1e30)
    weights, idx = torch.topk(logits, mo.top_k, dim=-1)
    return torch.softmax(weights, dim=-1), idx.to(torch.int32)


def moe_dense(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Masked dense MoE: out = sum_e gate_e(x) * FFN_e(x), every (padded)
    expert on every token, as the reference computes it (E/K times the
    active FLOPs).  The combine weights [B,S,E] hold each token's routing
    weight at its k experts (the reference's one-hot contraction: the k
    indices are distinct, so each entry is one weight or 0) and scale the
    hidden activations before the down projection."""
    mo = cfg.moe
    E = p.router.shape[-1]
    weights, idx = _route(p, x, mo)
    combine = torch.zeros(*idx.shape[:-1], E, dtype=torch.float32,
                          device=x.device)
    combine = combine.scatter(-1, idx.long(), weights).to(x.dtype)
    h = torch.einsum("bsd,edf->bsef", x, p.w_gate.to(x.dtype))
    u = torch.einsum("bsd,edf->bsef", x, p.w_up.to(x.dtype))
    h = silu(h) * u
    h = h * combine[..., None]
    out = torch.einsum("bsef,efd->bsd", h, p.w_down.to(x.dtype))
    if cfg.moe.num_shared_experts:
        out = out + mlp(p.shared, x)
    return out


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's dispatcher with no mesh: :func:`moe_dense` for both
    ``impl="dense"`` and ``impl="ep"``."""
    return moe_dense(p, x, cfg)
