"""Serve-step factories: the port of the reference's
``repro.train.step.make_prefill_step`` / ``make_decode_step``.

``make_prefill_step`` runs the whole prompt through the full-sequence
forward (on the card: the flash-attention kernel for the dense family,
the chunked-mLSTM kernel once per mLSTM block for xlstm) and returns the
last position's logits; ``make_decode_step`` takes one greedy token.  The
training step (``make_train_step``, AdamW, schedules) belongs to a later
slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..configs.base import ArchConfig
from ..models import api


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        logits = api.forward(params, batch["tokens"], cfg,
                             batch.get("frontend"))
        # serving returns only the last position's logits
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def decode_step(params, tokens, cache):
        logits, cache = api.decode_step(params, tokens, cache, cfg)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token.to(torch.int32), cache

    return decode_step
