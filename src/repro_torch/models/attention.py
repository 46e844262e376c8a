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
from ..distrib.sharding import (full, gqa_on_local, is_dtensor, linear,
                                local_shape_and_offset, reshape)
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
    q = linear(x, p.wq.to(x.dtype))
    k = linear(x, p.wk.to(x.dtype))
    v = linear(x, p.wv.to(x.dtype))
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = reshape(q, B, S, cfg.num_heads, hd)
    k = reshape(k, B, S, cfg.num_kv_heads, hd)
    v = reshape(v, B, S, cfg.num_kv_heads, hd)
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
        def flash(a, b, c, _g=None):
            return fa_ops.flash_attention(a, b, c, causal=True, window=window,
                                          softcap=cfg.attn_softcap)

        # on DTensors the kernel runs on each rank's own heads
        out = reshape(gqa_on_local(flash, q, k, v) if is_dtensor(q)
                      else flash(q, k, v), B, S, -1)
    elif lane != "train":
        raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
    elif is_dtensor(q):
        # each rank's own heads, on plain tensors; positions are 0..S-1
        out = reshape(gqa_on_local(lambda a, b, c, g: _causal_core(
            a, b, c, cfg, torch.arange(S, device=a.device)[None], window
        ).reshape(a.shape), q, k, v), B, S, -1)
    else:
        out = _causal_core(q, k, v, cfg, positions, window)
    return linear(out, p.wo.to(x.dtype))


def _causal_core(q, k, v, cfg: ArchConfig, positions, window: int):
    """The train lane's attention after the projections: :func:`_sdpa_chunked`
    when S is a multiple of :data:`QCHUNK` above it, else :func:`_sdpa`
    with the causal (and window) mask."""
    S = q.shape[1]
    if S > QCHUNK and S % QCHUNK == 0 and not cfg.cost_analysis_mode:
        return _sdpa_chunked(q, k, v, cfg, positions, window)
    return _sdpa(q, k, v, causal_mask(positions, positions, window), cfg)


def full_attention(q, k, v, cfg: ArchConfig) -> torch.Tensor:
    """Unmasked :func:`_sdpa` (the encoder's and the cross-attention's),
    q [B, Sq, H, hd], k, v [B, Sk, Hkv, hd] -> [B, Sq, H * hd]; on
    DTensors each rank runs its own heads."""
    def core(a, b, c, _g=None):
        mask = torch.ones(a.shape[1], b.shape[1], dtype=torch.bool,
                          device=a.device)
        return _sdpa(a, b, c, mask, cfg)

    if is_dtensor(q):
        B, Sq, H, hd = q.shape
        return reshape(gqa_on_local(
            lambda a, b, c, g: core(a, b, c).reshape(a.shape), q, k, v),
            B, Sq, H * hd)
    return core(q, k, v)


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


def _write_at(cache: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> None:
    """``cache[b, pos[b]] = new[b, 0]`` for every row b, in place, with
    ``pos`` clamped to [0, T-1] (as the reference's
    ``dynamic_update_slice`` clamps).  cache [B, T, ...], new [B, 1, ...].
    On a DTensor cache each rank writes into its own shard: ``new`` comes
    in the cache's layout (its length-1 T dim whole), and a rank whose
    shard of T does not hold ``pos[b]`` keeps its rows as they were."""
    T = cache.shape[1]
    at = pos.long().clamp(0, T - 1)
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, at] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate

    mesh, pl = cache.device_mesh, cache.placements
    new_pl = tuple(Replicate() if q.is_shard() and q.dim == 1 else q
                   for q in pl)
    new_l = new.to(cache.dtype).redistribute(mesh, new_pl).to_local()
    local = cache.to_local()
    shape, offset = local_shape_and_offset(cache.shape, mesh, pl)
    b0, t0 = offset[0], offset[1]
    at = full(at)[b0:b0 + shape[0]] - t0
    mine = (at >= 0) & (at < shape[1])
    at = at.clamp(0, max(shape[1] - 1, 0))
    rows = torch.arange(shape[0], device=local.device)
    keep = mine.reshape(-1, *([1] * (local.dim() - 2)))
    local[rows, at] = torch.where(keep, new_l[:, 0], local[rows, at])


def decode_attention(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: torch.Tensor, window: int = 0):
    """One-token decode: x [B,1,D]; k/v_cache [B,T,Hkv,hd]; cache_pos [B].

    Writes the new K/V row of every sequence into the caches in place, at
    ``cache_pos`` clamped to [0, T-1] (as the reference's
    ``dynamic_update_slice`` clamps), and returns (out [B,1,D], k_cache,
    v_cache)."""
    T = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_pos[:, None])
    _write_at(k_cache, k_new, cache_pos)
    _write_at(v_cache, v_new, cache_pos)
    valid = _valid_keys(cache_pos, T, window)            # [B,T]
    out = _decode_core(q, k_cache.to(q.dtype), v_cache.to(q.dtype), valid,
                       cfg)
    return linear(out, p.wo.to(x.dtype)), k_cache, v_cache


def _decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One-token attention over the cache: q [B, 1, H, hd], k, v [B, T,
    Hkv, hd], valid [B, T] -> [B, 1, H * hd] (:func:`_sdpa`).  On a
    DTensor cache it runs in the cache's own layout (the reference's
    cache spec: batch over the DP axes, or T over 'data' for one long
    sequence, and hd over 'model'), so no rank gathers the cache: each
    rank takes the scores of its hd slice and its keys, the scores are
    summed over the ranks that split hd, the softmax is taken across the
    ranks that split T (their maxima and sums exchanged), and each rank
    keeps its hd slice of the output."""
    if not is_dtensor(k):
        return _sdpa(q, k, v, valid[:, None], cfg)
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = k.device_mesh, k.placements
    B, _, H, hd = q.shape
    T = k.shape[1]
    q_pl = tuple(Replicate() if p.is_shard() and p.dim in (1, 2) else p
                 for p in pl)
    m_pl = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                 for p in pl)
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, pl).to_local()
    vl = v.redistribute(mesh, pl).to_local()
    ml = valid.redistribute(mesh, m_pl).to_local()
    hd_groups = [mesh.get_group(i) for i, p in enumerate(pl)
                 if p.is_shard() and p.dim == 3]
    t_groups = [mesh.get_group(i) for i, p in enumerate(pl)
                if p.is_shard() and p.dim == 1]

    def reduce(t, op, groups):
        for g in groups:
            t = fc.all_reduce(t, op, g)
            t = t.wait() if hasattr(t, "wait") else t
        return t

    Bl, Tl, Hkv, hdl = kl.shape
    G = H // Hkv
    qg = ql.reshape(Bl, 1, Hkv, G, hdl)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl)
    scores = reduce(scores, "sum", hd_groups) \
        / scalar_in(math.sqrt(hd), q.dtype)
    if cfg.attn_softcap > 0:
        scores = softcap(scores.float(), cfg.attn_softcap)
    scores = scores.float().masked_fill(~ml[:, None, None, None], NEG_INF)
    mx = reduce(scores.amax(dim=-1, keepdim=True), "max", t_groups)
    e = torch.exp(scores - mx)
    den = reduce(e.sum(dim=-1, keepdim=True), "sum", t_groups)
    out = torch.einsum("bhgqk,bkhd->bqhgd", (e / den).to(q.dtype), vl)
    out = reduce(out, "sum", t_groups).reshape(Bl, 1, H, hdl)
    o_pl = tuple(p if p.is_shard() and p.dim in (0, 3) else Replicate()
                 for p in pl)
    shape = (B, 1, H, hd)
    out = DTensor.from_local(out.contiguous(), mesh, o_pl, run_check=False,
                             shape=shape, stride=(H * hd, H * hd, hd, 1))
    return reshape(out, B, 1, H * hd)


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
    T = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, cache_pos[:, None])
    kq, ks_new = _quantize_row(k_new)                    # [B,1,H,hd],[B,1,H]
    vq, vs_new = _quantize_row(v_new)
    for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ks_new),
                       (v_scale, vs_new)):
        _write_at(cache, new, cache_pos)
    k = k_cache.to(q.dtype) * k_scale.to(q.dtype)[..., None]
    v = v_cache.to(q.dtype) * v_scale.to(q.dtype)[..., None]
    valid = _valid_keys(cache_pos, T, window)
    out = _decode_core(q, k, v, valid, cfg)
    return linear(out, p.wo.to(x.dtype)), k_cache, v_cache, k_scale, v_scale
