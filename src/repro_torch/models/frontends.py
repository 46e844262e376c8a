"""Modality frontends: the stand-in patch and frame embeddings.

The port of the reference's ``repro.models.frontends``.  The vlm and audio
configs specify the transformer backbone only; their frontend is a stub
whose embeddings [B, F, d_model] come precomputed.  These helpers give
the stub's shape and deterministic synthetic embeddings.

The port cannot reproduce ``jax.random``'s bits: :func:`synthetic_frontend`
draws the same distribution (standard normal times 0.02, f32) from a
``torch.Generator``, so its values differ from the reference's for the
same seed.  Tests that compare the two packages make one numpy frontend
and hand it to both.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels._cuda import resolve_device


def frontend_shape(cfg: ArchConfig, batch: int):
    """Shape of the precomputed patch/frame embeddings, or ``None`` when
    the config has no frontend."""
    if cfg.frontend_tokens <= 0:
        return None
    return (batch, cfg.frontend_tokens, cfg.d_model)


def synthetic_frontend(cfg: ArchConfig, batch: int, seed: int = 0, *,
                       device="cuda"):
    """Seeded stand-in embeddings, normal times 0.02 in f32, on ``device``
    (default ``"cuda"``, which raises without a card), or ``None``."""
    shape = frontend_shape(cfg, batch)
    if shape is None:
        return None
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).mul_(0.02)
