"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395).

The port of ``repro.optim.schedules``: functions of the step counter (an
int or an integer tensor) that return a 0-dim float32 tensor on the
step's device, computed in float32 in the reference's order.  WSD is the
schedule minicpm-2b was trained with (``train.step.lr_for``).
"""
from __future__ import annotations

import math

import torch


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    t = _t(step)
    warm = t / max(1.0, warmup_steps)
    prog = torch.clamp((t - warmup_steps) / max(1.0, total_steps
                                                - warmup_steps), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                              * prog))
    return peak_lr * torch.where(t < warmup_steps, warm, cos)


def wsd_schedule(step, *, peak_lr: float, warmup_steps: int,
                 stable_steps: int, decay_steps: int,
                 final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> Stable (constant) -> Decay (exponential-ish linear)."""
    t = _t(step)
    warm = t / max(1.0, warmup_steps)
    in_decay = t - (warmup_steps + stable_steps)
    decay = torch.pow(final_frac, torch.clamp(
        in_decay / max(1.0, decay_steps), 0, 1))
    lr = torch.where(t < warmup_steps, warm,
                     torch.where(in_decay < 0, torch.ones_like(t), decay))
    return peak_lr * lr
