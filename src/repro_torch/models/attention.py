"""GQA attention: full-sequence (prefill and training) and one-token
decode with a cache.

The port of the reference's ``repro.models.attention``.  Full-sequence
:func:`attention` has two lanes, chosen by the caller.  The kernel lane
(prefill) goes through the flash-attention dispatcher
(``kernels.flash_attention.ops``), which launches the hand-written CUDA
kernel for a CUDA tensor and runs its plain version for a CPU tensor; it
does not read ``cfg.use_pallas``.  The kernel has no backward (nor has
the reference's Pallas kernel), so the training lane is the reference's
XLA path (``_sdpa``, ``_sdpa_chunked``) in plain torch under autograd.
Decode (:func:`decode_attention`, :func:`decode_attention_quant`) stays in
plain torch ops over the cache, as the reference leaves it to XLA outside
any Pallas kernel.

The KV cache is bfloat16 whatever ``cfg.dtype`` is (the reference's
``init_kv_cache`` default, which ``lm.init_cache`` keeps), or int8 with
bf16 scales under ``cfg.kv_quant``; decode writes the new row into it in
place.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as fa_ops
from .common import (apply_rope, causal_mask, dense_init, scalar_in, softcap,
                     weight)

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


QCHUNK = 512          # query-block size for the chunked-attention path


def _sdpa_chunk(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                qpos: torch.Tensor, kpos: torch.Tensor, window: int,
                cfg: ArchConfig) -> torch.Tensor:
    return _sdpa(qc, k, v, causal_mask(qpos, kpos, window), cfg)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ArchConfig, positions: torch.Tensor, window: int,
                  chunk: int = QCHUNK) -> torch.Tensor:
    """Exact attention with O(chunk * S) score memory: each block of
    ``chunk`` queries takes its full softmax row over every key, so this
    equals :func:`_sdpa` over the whole sequence.  Each block is
    checkpointed (the reference's ``jax.checkpoint`` per scanned chunk):
    the backward re-forms a block's scores instead of keeping all of
    them, which would be the whole [S, S] matrix again."""
    S = q.shape[1]
    outs = [checkpoint(_sdpa_chunk, q[:, c:c + chunk], k, v,
                       positions[:, c:c + chunk], positions, window, cfg,
                       use_reentrant=False)
            for c in range(0, S, chunk)]
    return torch.cat(outs, dim=1)


LANES = ("kernel", "train")


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, window: int = 0,
              lane: str = "kernel") -> torch.Tensor:
    """Full-sequence causal attention: positions are 0..S-1.

    ``lane="kernel"`` (prefill) runs the flash-attention kernel, which has
    no backward and raises on inputs that require grad.  ``lane="train"``
    is the reference's XLA path in plain torch, under autograd:
    :func:`_sdpa_chunked` when S is a multiple of :data:`QCHUNK` above it,
    else :func:`_sdpa` with the causal (and window) mask."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if lane == "kernel":
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     softcap=cfg.attn_softcap)
        out = out.reshape(B, S, -1)
    elif lane != "train":
        raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
    elif S > QCHUNK and S % QCHUNK == 0 and not cfg.cost_analysis_mode:
        out = _sdpa_chunked(q, k, v, cfg, positions, window)
    else:
        out = _sdpa(q, k, v, causal_mask(positions, positions, window), cfg)
    return out @ p.wo.to(x.dtype)


# --------------------------------------------------------------------- decode
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, layers: int,
                  dtype: torch.dtype = torch.bfloat16, *, device=None):
    """K/V [L, B, max_len, Hkv, hd] and ``pos`` [B].  With ``cfg.kv_quant``
    K and V are int8 with per-(position, head) bf16 scales ``k_scale``,
    ``v_scale`` [L, B, max_len, Hkv]: half the bytes of a bf16 cache (the
    reference's int8 cache for MHA configs such as minicpm-2b)."""
    hd = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.num_kv_heads, hd)
    pos = torch.zeros(batch, dtype=torch.int32, device=device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}


def _quantize_row(x: torch.Tensor):
    """x: [..., hd] -> (int8 values, bf16 scale over the last dim).

    As the reference orders it: the scale is amax / 127 in f32, the values
    are rounded (half to even) with that f32 scale, and only then is the
    scale stored in bf16."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def _valid_keys(cache_pos: torch.Tensor, T: int, window: int
                ) -> torch.Tensor:
    """[B, T]: the cached keys a one-token query at ``cache_pos`` sees."""
    k_pos = torch.arange(T, device=cache_pos.device)[None, :]
    valid = k_pos <= cache_pos[:, None]
    if window > 0:
        valid = valid & (k_pos > cache_pos[:, None] - window)
    return valid


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
    valid = _valid_keys(cache_pos, T, window)            # [B,T]
    out = _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), valid[:, None],
                cfg)
    return out @ p.wo.to(x.dtype), k_cache, v_cache


def decode_attention_quant(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           cache_pos: torch.Tensor, window: int = 0):
    """int8-KV decode: k/v_cache [B,T,Hkv,hd] int8 with bf16 scales
    k/v_scale [B,T,Hkv].  The new row and its scales are written in place
    at ``cache_pos`` clamped to [0, T-1]; the whole cache is dequantized
    (int8 times the bf16 scale, both in the compute dtype) for the
    attention.  Returns (out [B,1,D], k_cache, v_cache, k_scale,
    v_scale)."""
    B = x.shape[0]
    T = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_pos[:, None])
    kq, ks_new = _quantize_row(k_new)                    # [B,1,H,hd],[B,1,H]
    vq, vs_new = _quantize_row(v_new)
    rows = torch.arange(B, device=x.device)
    at = cache_pos.long().clamp(0, T - 1)
    k_cache[rows, at] = kq[:, 0]
    v_cache[rows, at] = vq[:, 0]
    k_scale[rows, at] = ks_new[:, 0]
    v_scale[rows, at] = vs_new[:, 0]
    k = k_cache.to(q.dtype) * k_scale.to(q.dtype)[..., None]
    v = v_cache.to(q.dtype) * v_scale.to(q.dtype)[..., None]
    valid = _valid_keys(cache_pos, T, window)
    out = _sdpa(q, k, v, valid[:, None], cfg)
    return out @ p.wo.to(x.dtype), k_cache, v_cache, k_scale, v_scale
