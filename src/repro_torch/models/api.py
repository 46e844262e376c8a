"""Family-dispatching model API: one entry point for every ported family.

    init_params(key, cfg, device=...)          -> params (an ``lm.LM``)
    forward(params, tokens, cfg, frontend)     -> logits
    loss_fn(params, tokens, targets, cfg, ...) -> scalar
    init_cache(cfg, batch, max_len, ...)       -> decode cache
    decode_step(params, tokens, cache, cfg)    -> (logits, cache)

The port of the reference's ``repro.models.api`` for the dense and ssm
(xlstm) families.  ``forward`` and ``decode_step`` serve under
``torch.no_grad()`` through the kernels; ``loss_fn`` runs the training
lane under autograd (``lm.loss_fn``).  ``key`` is
an int seed or a ``torch.Generator``.  ``device`` defaults to ``"cuda"``
and raises without a card; pass ``device="cpu"`` to run the kernels'
plain versions.
"""
from __future__ import annotations

from typing import Union

import torch

from ..configs.base import ArchConfig
from . import lm


def generator(key: Union[int, torch.Generator]) -> torch.Generator:
    """``key`` as a ``torch.Generator`` (an int seeds a CPU generator)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def init_params(key, cfg: ArchConfig, *, device="cuda") -> lm.LM:
    return lm.init_params(generator(key), cfg, device=device)


def forward(params: lm.LM, tokens, cfg: ArchConfig, frontend=None):
    return lm.forward(params, tokens, cfg, frontend)


def loss_fn(params: lm.LM, tokens, targets, cfg: ArchConfig,
            frontend=None):
    return lm.loss_fn(params, tokens, targets, cfg, frontend)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    return lm.init_cache(cfg, batch, max_len, device=device)


def decode_step(params: lm.LM, tokens, cache, cfg: ArchConfig):
    return lm.decode_step(params, tokens, cache, cfg)
