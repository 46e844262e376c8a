"""The reference's weights, optimizer state and decode cache, carried
across as numpy, both ways.

``params_from_jax`` takes the reference's parameter tree as nested dicts of
numpy arrays (what ``jax.tree.map(np.asarray, params)`` gives; the caller
makes it, the port never imports JAX) and fills the port's modules,
unstacking the reference's layer stacks: ``layers`` ``[L, ...]`` (an MoE
layer's stacked experts ``moe.w_gate`` [L, E, d, f] stay whole per layer;
``ssm.*`` likewise); for ssm (xlstm), ``mlstm`` leaves and ``ln_m``
``[G, M, ...]``, ``slstm`` leaves and ``ln_s`` ``[G, ...]``; for the
encoder-decoder (``family="audio"``, an ``encdec.EncDec``),
``enc_layers`` and ``dec_layers`` (``xattn`` included) ``[L, ...]``.
``cache_from_jax`` and ``cache_to_numpy`` carry the decode cache both
ways, nested dicts included, so a test can compare the two decode paths
step by step; an int8 cache's int8 K/V and bf16 scales cross unchanged
(the scales come out of the port as float32, exactly), as do the hybrid
cache's nested ``ssm.{state, conv}`` and the encoder-decoder's ``enc``.

``params_to_numpy`` is the inverse of ``params_from_jax``: the port's
per-layer tensors (an ``LM`` or ``EncDec``, or any mapping by parameter
name, such as its grads or AdamW moments) stacked back into the
reference's tree, so a test compares grads and updated parameters leaf by
leaf.
``adamw_from_jax`` and ``adamw_to_numpy`` carry the AdamW state.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distrib.sharding import full
from ..kernels._cuda import resolve_device
from ..optim.adamw import AdamWState
from .encdec import EncDec
from .lm import LM, xlstm_groups


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
def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig, device="cuda"):
    """An ``LM``, or an ``EncDec`` for ``family="audio"``."""
    device = resolve_device(device)
    p = (EncDec if cfg.family == "audio" else LM)(cfg, device=device)
    p.embed.copy_(to_tensor(tree["embed"]))
    p.final_norm.copy_(to_tensor(tree["final_norm"]))
    if not cfg.tie_embeddings:
        p.lm_head.copy_(to_tensor(tree["lm_head"]))
    if cfg.family == "audio":
        p.enc_norm.copy_(to_tensor(tree["enc_norm"]))
        for name in ("enc_layers", "dec_layers"):
            for i, blk in enumerate(getattr(p, name)):
                _fill(blk, tree[name], i)
        return p
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (a CPU tensor's ``numpy()`` would share its memory, and the
    train step updates parameters in place)."""
    t = full(t.detach()).cpu()       # a DTensor whole (a gather)
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _nest(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for part in path:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def reference_leaf(name: str) -> str:
    """The dotted path of the reference's stacked leaf that holds the
    port's parameter ``name``: ``layers.3.attn.wq`` -> ``layers.attn.wq``;
    ``groups.1.mlstm.4.w_in`` -> ``mlstm.w_in``; ``groups.1.ln_m`` ->
    ``ln_m``; ``groups.1.slstm.w_out`` -> ``slstm.w_out``;
    ``dec_layers.2.xattn.wq`` -> ``dec_layers.xattn.wq``."""
    for pattern, prefix in ((r"layers\.\d+\.(.+)", "layers."),
                            (r"enc_layers\.\d+\.(.+)", "enc_layers."),
                            (r"dec_layers\.\d+\.(.+)", "dec_layers."),
                            (r"groups\.\d+\.mlstm\.\d+\.(.+)", "mlstm."),
                            (r"groups\.\d+\.(.+)", "")):
        m = re.fullmatch(pattern, name)
        if m:
            return prefix + m.group(1)
    return name


def by_reference_leaf(names) -> Dict[str, List[str]]:
    """The port's parameter names grouped by :func:`reference_leaf`, each
    group in stacking order (layer, or supergroup then block)."""
    groups: Dict[str, List[str]] = {}
    for n in names:
        groups.setdefault(reference_leaf(n), []).append(n)
    return groups


def params_to_numpy(params, cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's parameter tree as numpy (bfloat16 as float32):
    ``layers`` (or ``enc_layers``, ``dec_layers``) leaves stacked
    [L, ...]; for ssm,
    ``mlstm`` leaves and ``ln_m`` [G, M, ...], ``slstm`` leaves and
    ``ln_s`` [G, ...]."""
    flat = {n: _numpy(t) for n, t in (params.named_parameters()
                                      if isinstance(params, torch.nn.Module)
                                      else params.items())}
    tree: Dict[str, Any] = {}
    for key, names in by_reference_leaf(flat).items():
        if key == names[0]:                       # not stacked
            _nest(tree, key, flat[key])
            continue
        a = np.stack([flat[n] for n in names])
        if key.startswith("mlstm."):
            a = a.reshape(*xlstm_groups(cfg), *a.shape[1:])
        _nest(tree, key, a)
    return tree


def adamw_from_jax(state, cfg: ArchConfig, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (step, and mu and nu as parameter
    trees of numpy arrays) as the port's: mu and nu keyed by the port's
    parameter names."""
    def by_name(tree):
        return {n: p.detach() for n, p in
                params_from_jax(tree, cfg, device).named_parameters()}

    device = resolve_device(device)
    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=device),
                      mu=by_name(state.mu), nu=by_name(state.nu))


def adamw_to_numpy(state: AdamWState, cfg: ArchConfig) -> Dict[str, Any]:
    """The port's AdamW state as ``{"step": int, "mu": tree, "nu": tree}``
    in the reference's layout."""
    return {"step": int(state.step), "mu": params_to_numpy(state.mu, cfg),
            "nu": params_to_numpy(state.nu, cfg)}
