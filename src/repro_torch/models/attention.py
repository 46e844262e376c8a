"""GQA attention: full-sequence (prefill) and one-token decode with a cache.

The port of the reference's ``repro.models.attention``.  Full-sequence
:func:`attention` always goes through the flash-attention dispatcher
(``kernels.flash_attention.ops``), which launches the hand-written CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor; it
does not read ``cfg.use_pallas``, and has no separate XLA lane.  Decode
(:func:`decode_attention`) stays in plain torch ops over the cache, as the
reference leaves it to XLA outside any Pallas kernel.

The KV cache is bfloat16 whatever ``cfg.dtype`` is (the reference's
``init_kv_cache`` default, which ``lm.init_cache`` keeps), and decode
writes the new row into it in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as fa_ops
from .common import apply_rope, dense_init, scalar_in, softcap, weight

NEG_INF = -2.3819763e38          # bf16-safe large negative


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        D, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.wq = weight((D, H * hd), device)
        self.wk = weight((D, Hkv * hd), device)
        self.wv = weight((D, Hkv * hd), device)
        self.wo = weight((H * hd, D), device)
        if cfg.qkv_bias:
            self.bq = weight((H * hd,), device)
            self.bk = weight((Hkv * hd,), device)
            self.bv = weight((Hkv * hd,), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "Attention":
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(dense_init(gen, *w.shape))
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        return self


def init_attn(gen: torch.Generator, cfg: ArchConfig, *, device=None
              ) -> Attention:
    return Attention(cfg, device=device).reset_parameters(gen)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Hkv,hd]; mask: [B,Sq,Sk] or [Sq,Sk]."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) \
        / scalar_in(math.sqrt(hd), q.dtype)
    if cfg.attn_softcap > 0:
        scores = softcap(scores.float(), cfg.attn_softcap)
    scores = scores.float()
    m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    scores = scores.masked_fill(~m, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H * hd)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Full-sequence causal attention (prefill): positions are 0..S-1."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p.wo.to(x.dtype)


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, layers: int,
                  dtype: torch.dtype = torch.bfloat16, *, device=None):
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV cache (kv_quant, decode_attention_quant) is not ported "
            "yet: ROADMAP queue 1 item 10")
    hd = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def decode_attention(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: torch.Tensor, window: int = 0):
    """One-token decode: x [B,1,D]; k/v_cache [B,T,Hkv,hd]; cache_pos [B].

    Writes the new K/V row of every sequence into the caches in place, at
    ``cache_pos`` clamped to [0, T-1] (as the reference's
    ``dynamic_update_slice`` clamps), and returns (out [B,1,D], k_cache,
    v_cache)."""
    B = x.shape[0]
    T = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_pos[:, None])
    rows = torch.arange(B, device=x.device)
    at = cache_pos.long().clamp(0, T - 1)
    k_cache[rows, at] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v_new[:, 0].to(v_cache.dtype)
    k_pos = torch.arange(T, device=x.device)[None, :]
    valid = k_pos <= cache_pos[:, None]                  # [B,T]
    if window > 0:
        valid = valid & (k_pos > cache_pos[:, None] - window)
    out = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), valid[:, None],
                cfg)
    return out @ p.wo.to(x.dtype), k_cache, v_cache
