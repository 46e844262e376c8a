"""AdamW (the reference's, from scratch: no ``torch.optim.AdamW``).

The port of ``repro.optim.adamw``: the optimizer state mirrors the
parameter tree (``optim.tree``), and the update is the reference's
function, rounding for rounding in float32: b1 0.9, b2 0.95, eps 1e-8 and
decoupled weight decay 0.1 on *every* leaf (norms and embeddings
included), bias correction from the incremented step, and global-norm
clipping with scale ``min(1, max_norm / (norm + 1e-9))``.
``torch.optim.AdamW`` differs in its defaults (b2 0.999, weight decay
0.01) and its order of operations.  ``adamw_update`` returns new trees;
``adamw_update_`` (the train step's) writes the same values in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .tree import tree_field, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32, 0-dim: updates taken so far
    mu: Any
    nu: Any


@torch.no_grad()
def init_adamw(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(leaf.float().square().sum()
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _leaf_update(g, m, v, p, lr, t, b1, b2, eps, weight_decay):
    """The reference's per-leaf AdamW arithmetic, in its order: returns
    (new param, new mu, new nu)."""
    g32 = g.float()
    m2 = b1 * m + (1 - b1) * g32
    v2 = b2 * v + (1 - b2) * g32 * g32
    mhat = m2 / (1 - b1 ** t)
    vhat = v2 / (1 - b2 ** t)
    delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m2, v2


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One update.  ``lr`` is a float or a 0-dim f32 tensor (a schedule's
    value).  Returns (new params, new state) as trees of new tensors."""
    step = state.step + 1
    t = step.float()
    out = tree_map(lambda g, m, v, p: _leaf_update(
        g, m, v, p, lr, t, b1, b2, eps, weight_decay),
        grads, state.mu, state.nu, params)
    return tree_field(out, 0), AdamWState(step=step, mu=tree_field(out, 1),
                                          nu=tree_field(out, 2))


@torch.no_grad()
def adamw_update_(grads, state: AdamWState, params, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1) -> AdamWState:
    """:func:`adamw_update` in place, one leaf at a time: each parameter,
    mu and nu is overwritten with its update, so the peak memory is one
    leaf's temporaries instead of a second copy of the parameters and both
    moments (xlstm-1.3b: 2.7e9 parameters, 33 GB).  The reference's
    launcher gets the same by donating params and optimizer state.
    Returns the new state, which shares mu and nu with ``state``."""
    step = state.step + 1
    t = step.float()

    def upd(g, m, v, p):
        p2, m2, v2 = _leaf_update(g, m, v, p, lr, t, b1, b2, eps,
                                  weight_decay)
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)

    tree_map(upd, grads, state.mu, state.nu, params)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
