"""Shared model components: initializers, norms, RoPE, masks, activations.

The port of the reference's ``repro.models.common``, with its numerics:
``rms_norm`` takes the variance in f32 and scales by ``(1 + gamma)`` in the
compute dtype; ``apply_rope`` rotates split halves with f32 angles and the
rotation in the compute dtype.  Initializers draw from a
``torch.Generator`` (the reference's ``jax.random`` numbers differ; tests
carry weights across with :mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (the reference's
    ``jnp.asarray(value, dtype)`` scalar), as a Python float."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


# ----------------------------------------------------------------- initializers
def weight(shape, device=None) -> nn.Parameter:
    """An uninitialised f32 parameter (``param_dtype``) that takes a
    gradient; the serving entry points run under ``torch.no_grad()``."""
    return nn.Parameter(torch.empty(shape, device=device))


def cast_params(module: nn.Module, dtype: torch.dtype):
    """``module``'s tree as plain namespaces (an ``nn.ModuleList`` as a
    list), each float32 parameter replaced by a copy cast to ``dtype``
    under autograd, so the gradient reaches the float32 parameter.  The
    model functions read parameters by attribute and run on it unchanged:
    what the train step's ``cast_bf16`` feeds the loss.  The copies are
    tensors made once, so a checkpointed block recomputes from the same
    values it ran on."""
    if isinstance(module, nn.ModuleList):
        return [cast_params(m, dtype) for m in module]
    ns = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, p.to(dtype) if p.dtype == torch.float32 else p)
    for name, m in module.named_children():
        setattr(ns, name, cast_params(m, dtype))
    return ns


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int
               ) -> torch.Tensor:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) ``[in, out]`` f32 weight on the
    generator's device (the model applies it as ``x @ w``)."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand(in_dim, out_dim, generator=gen, device=gen.device)
    return w.mul_(2 * scale).sub_(scale)


VOCAB_PAD_MULTIPLE = 256      # the reference's 16 (model) x 16 (data) grid


def padded_vocab(vocab: int) -> int:
    """Embedding rows, padded as the reference pads them; the padding ids
    are unreachable and their logits are masked (:func:`mask_vocab_pad`)."""
    m = VOCAB_PAD_MULTIPLE
    return -(-vocab // m) * m


def embed_init(gen: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    return torch.randn(padded_vocab(vocab), dim, generator=gen,
                       device=gen.device).mul_(0.02)


def mask_vocab_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Padded vocab columns set to -1e30 (softmax/argmax-safe)."""
    Vp = logits.shape[-1]
    if Vp == vocab:
        return logits
    col = torch.arange(Vp, device=logits.device) >= vocab
    return logits.masked_fill(col, -1e30)


# ------------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance), scaled by
    ``gamma``, shifted by ``beta`` and cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [hd/2]
    angles = positions[..., :, None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------- masking
def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
    """Boolean [.., Sq, Sk] mask: key <= query, and key > query - window
    when ``window`` > 0 (a Python int: the port has no scanned layers)."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
