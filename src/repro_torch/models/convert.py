"""The reference's weights and decode cache, carried across as numpy.

``params_from_jax`` takes the reference's parameter tree as nested dicts of
numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives; the caller
makes it, the port never imports JAX) and fills the port's modules,
unstacking the reference's layer stacks: ``[L, ...]`` for the dense
family; for ssm, ``mlstm`` leaves and ``ln_m`` ``[G, M, ...]``, ``slstm``
leaves and ``ln_s`` ``[G, ...]``.  ``cache_from_jax`` and
``cache_to_numpy`` carry the decode cache both ways, nested dicts
included, so a test can compare the two decode paths step by step.
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


def _fill(module: torch.nn.Module, tree: Dict[str, Any], index) -> None:
    """Each parameter of ``module``, named ``a.b``, from ``tree[a][b]`` at
    ``index`` of its stacked leading axes."""
    for name, param in module.named_parameters():
        node = tree
        for part in name.split("."):
            node = node[part]
        param.copy_(to_tensor(node[index]))


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig, device="cuda"
                    ) -> LM:
    device = resolve_device(device)
    p = LM(cfg, device=device)
    p.embed.copy_(to_tensor(tree["embed"]))
    p.final_norm.copy_(to_tensor(tree["final_norm"]))
    if not cfg.tie_embeddings:
        p.lm_head.copy_(to_tensor(tree["lm_head"]))
    if cfg.family == "ssm":
        for g, grp in enumerate(p.groups):
            for m, blk in enumerate(grp.mlstm):
                _fill(blk, tree["mlstm"], (g, m))
            grp.ln_m.copy_(to_tensor(tree["ln_m"][g]))
            _fill(grp.slstm, tree["slstm"], g)
            grp.ln_s.copy_(to_tensor(tree["ln_s"][g]))
        return p
    for i, blk in enumerate(p.layers):
        _fill(blk, tree["layers"], i)
    return p


def cache_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    device = resolve_device(device)
    return {name: cache_from_jax(a, device) if isinstance(a, dict)
            else to_tensor(a, device) for name, a in tree.items()}


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The cache as numpy arrays, nested as it is; bfloat16 tensors (K/V,
    conv windows) come out as float32 (exactly)."""
    return {name: cache_to_numpy(t) if isinstance(t, dict)
            else (t.float() if t.dtype == torch.bfloat16 else t)
            .cpu().numpy() for name, t in cache.items()}
