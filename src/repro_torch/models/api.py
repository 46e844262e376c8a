"""Family-dispatching model API: one entry point for every architecture.

    init_params(key, cfg, device=..., mesh=)   -> params
    forward(params, tokens, cfg, frontend)     -> logits
    loss_fn(params, tokens, targets, cfg, ...) -> scalar
    init_cache(cfg, batch, max_len, ...)       -> decode cache
    decode_step(params, tokens, cache, cfg)    -> (logits, cache)

The port of the reference's ``repro.models.api``.  ``family="audio"``
(seamless-m4t-medium) goes to the encoder-decoder, ``models.encdec``
(params an ``encdec.EncDec``); every other family to ``models.lm``
(params an ``lm.LM``): dense (smollm, gemma2, minicpm, qwen2.5), vlm
(internvl2, whose ``frontend`` patch embeddings are prepended to the
tokens), moe (granite-moe, qwen3-moe), hybrid (hymba) and ssm (xlstm).
``forward`` and ``decode_step`` serve under ``torch.no_grad()`` through
the kernels; ``loss_fn`` runs the training lane under autograd.  ``key``
is an int seed or a ``torch.Generator``.  ``device`` defaults to
``"cuda"`` and raises without a card; pass ``device="cpu"`` to run the
kernels' plain versions.
"""
from __future__ import annotations

from typing import Union

import torch

from ..configs.base import ArchConfig
from . import encdec, lm


def _mod(cfg: ArchConfig):
    return encdec if cfg.family == "audio" else lm


def generator(key: Union[int, torch.Generator]) -> torch.Generator:
    """``key`` as a ``torch.Generator`` (an int seeds a CPU generator)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def init_params(key, cfg: ArchConfig, *, device="cuda", mesh=None):
    """``mesh``: an expert-parallel mesh, whose 'model' rank holds only its
    own experts (``lm.init_params``); the other families ignore it."""
    if mesh is not None and cfg.family != "audio":
        return lm.init_params(generator(key), cfg, device=device, mesh=mesh)
    return _mod(cfg).init_params(generator(key), cfg, device=device)


def forward(params, tokens, cfg: ArchConfig, frontend=None):
    return _mod(cfg).forward(params, tokens, cfg, frontend)


def loss_fn(params, tokens, targets, cfg: ArchConfig, frontend=None):
    return _mod(cfg).loss_fn(params, tokens, targets, cfg, frontend)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


def decode_step(params, tokens, cache, cfg: ArchConfig):
    return _mod(cfg).decode_step(params, tokens, cache, cfg)
