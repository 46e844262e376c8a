"""The reference's weights and decode cache, carried across as numpy.

``params_from_jax`` takes the reference's parameter tree as nested dicts of
numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives; the caller
makes it, the port never imports JAX) and fills the port's modules,
unstacking the reference's ``[L, ...]`` layer stacks.  ``cache_from_jax``
and ``cache_to_numpy`` carry the decode cache both ways, so a test can
compare the two decode paths step by step.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels._cuda import resolve_device
from .lm import LM


def to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor, bfloat16 (numpy's ``ml_dtypes`` type)
    included."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:          # JAX hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig, device="cuda"
                    ) -> LM:
    device = resolve_device(device)
    p = LM(cfg, device=device)
    p.embed.copy_(to_tensor(tree["embed"]))
    p.final_norm.copy_(to_tensor(tree["final_norm"]))
    if not cfg.tie_embeddings:
        p.lm_head.copy_(to_tensor(tree["lm_head"]))
    layers = tree["layers"]
    for i, blk in enumerate(p.layers):
        for name, param in blk.named_parameters():
            node = layers
            for part in name.split("."):
                node = node[part]
            param.copy_(to_tensor(node[i]))
    return p


def cache_from_jax(tree: Dict[str, np.ndarray], device="cuda"
                   ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    return {name: to_tensor(a, device) for name, a in tree.items()}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The cache as numpy arrays; bfloat16 K/V come out as float32
    (exactly)."""
    return {name: (t.float() if t.dtype == torch.bfloat16 else t)
            .cpu().numpy() for name, t in cache.items()}
