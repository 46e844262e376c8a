"""Encoder-decoder transformer (the seamless-m4t-medium backbone,
``family="audio"``).

The port of the reference's ``repro.models.encdec``.  The speech frontend
is a stub: precomputed frame embeddings [B, F, D] feed the encoder, whose
self-attention is bidirectional (the plain ``_sdpa`` with an all-true
mask, RoPE on the frames).  The decoder is a causal transformer with
cross-attention to the encoder states; its full-sequence self-attention
goes through :func:`attention.attention`, so on the kernel lane
(:func:`forward`, serving) it is the hand-written flash kernel on the
card, and on the train lane (:func:`loss_fn`) the reference's XLA path in
plain torch.  Encoder and cross-attention are plain torch on both lanes,
as in the reference (no Pallas kernel there).

Decode keeps a bf16 self-attention K/V cache and the encoder states
``enc`` (bf16) in the cache, updated in place.  As in the reference,
:func:`init_cache` zeroes ``enc`` and nothing in the serving engines
writes it, so the engines decode against zero encoder states; a caller
that serves real frames sets ``cache["enc"]`` from :func:`encode` first.

:class:`EncDec` gives the surface the rest of the port reads from an
``lm.LM``: ``.device``, ``reset_parameters(gen)`` and
``named_parameters()``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels._cuda import resolve_device
from ..distrib.sharding import constrain, embedding, linear, reshape
from .attention import (LANES, Attention, _project_qkv, attention,
                        decode_attention, full_attention)
from .common import (dense_init, dtype_of, embed_init, mask_vocab_pad,
                     padded_vocab, rms_norm, weight)
from .lm import _remat, _seq_gather, _seq_shard, cross_entropy
from .mlp import MLP, mlp


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.ln1 = weight((cfg.d_model,), device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = weight((cfg.d_model,), device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "EncLayer":
        for m in self.children():
            m.reset_parameters(gen)
        for p in self.parameters(recurse=False):
            p.zero_()
        return self


class DecLayer(EncLayer):
    """An encoder layer's self-attention and MLP, plus the cross-attention
    ``xattn`` (the same projections as self-attention) and its pre-norm
    ``lnx``."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__(cfg, device=device)
        self.lnx = weight((cfg.d_model,), device)
        self.xattn = Attention(cfg, device=device)


class EncDec(nn.Module):
    """The parameters (f32): ``embed``, ``enc_layers``, ``dec_layers``,
    ``enc_norm``, ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        self.embed = weight((padded_vocab(cfg.vocab_size), cfg.d_model),
                            device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device=device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device=device)
                                        for _ in range(cfg.num_layers))
        self.enc_norm = weight((cfg.d_model,), device)
        self.final_norm = weight((cfg.d_model,), device)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model,
                                   padded_vocab(cfg.vocab_size)), device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "EncDec":
        """The reference's initializers (as :meth:`lm.LM.reset_parameters`),
        drawn from ``gen``."""
        self.embed.copy_(embed_init(gen, *self.embed.shape))
        for blk in (*self.enc_layers, *self.dec_layers):
            blk.reset_parameters(gen)
        self.enc_norm.zero_()
        self.final_norm.zero_()
        if hasattr(self, "lm_head"):
            self.lm_head.copy_(dense_init(gen, *self.lm_head.shape))
        return self


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device="cuda"
                ) -> EncDec:
    """Seeded weights on ``device`` (default ``"cuda"``, which raises
    without a card)."""
    return EncDec(cfg, device=resolve_device(device)).reset_parameters(gen)


XCHUNK = 512          # query-block size of the chunked cross-attention


def _cross_attention(p: Attention, x: torch.Tensor, enc: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """x: [B,Sq,D] queries; enc: [B,Sk,D] encoder states (keys and values),
    no RoPE, no mask.  Sq a multiple of :data:`XCHUNK` above it runs in
    query blocks, each checkpointed under autograd (the reference's
    ``jax.checkpoint`` on its scan body)."""
    B, Sq, _ = x.shape
    Sk = enc.shape[1]
    hd = cfg.resolved_head_dim
    q = reshape(linear(x, p.wq.to(x.dtype)), B, Sq, cfg.num_heads, hd)
    k = reshape(linear(enc, p.wk.to(x.dtype)), B, Sk, cfg.num_kv_heads, hd)
    v = reshape(linear(enc, p.wv.to(x.dtype)), B, Sk, cfg.num_kv_heads, hd)
    if Sq > XCHUNK and Sq % XCHUNK == 0:
        out = torch.cat([_remat(full_attention, q[:, c:c + XCHUNK], k, v,
                                cfg, on=torch.is_grad_enabled())
                         for c in range(0, Sq, XCHUNK)], dim=1)
    else:
        out = full_attention(q, k, v, cfg)
    return linear(out, p.wo.to(x.dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    """[1, S]: 0..S-1, broadcast over the batch."""
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]


def _enc_layer(lp: EncLayer, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    # bidirectional self-attention
    q, k, v = _project_qkv(lp.attn, h, cfg, positions)
    x = x + linear(full_attention(q, k, v, cfg), lp.attn.wo.to(x.dtype))
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp(lp.mlp, h)


def encode(params: EncDec, frames: torch.Tensor, cfg: ArchConfig, *,
           lane: str = "kernel") -> torch.Tensor:
    """frames: [B, F, D] stub embeddings -> encoder states [B, F, D] in the
    compute dtype.  Plain torch on both lanes; ``lane="train"``
    checkpoints each layer under ``cfg.remat``."""
    if lane not in LANES:
        raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
    x = frames.to(dtype_of(cfg.dtype))
    positions = _positions(x)
    remat = lane == "train" and cfg.remat
    for lp in params.enc_layers:
        x = _remat(_enc_layer, lp, x, cfg, positions, on=remat)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _dec_layer(lp: DecLayer, x: torch.Tensor, enc: torch.Tensor,
               cfg: ArchConfig, positions: torch.Tensor, lane: str
               ) -> torch.Tensor:
    # the reference's sequence parallelism after each layer, with each
    # branch scattered before its residual add (as in ``lm._block``)
    x = _seq_shard(x)
    h = _seq_gather(rms_norm(x, lp.ln1, cfg.norm_eps))
    x = x + _seq_shard(attention(lp.attn, h, cfg, positions, lane=lane))
    h = _seq_gather(rms_norm(x, lp.lnx, cfg.norm_eps))
    x = x + _seq_shard(_cross_attention(lp.xattn, h, enc, cfg))
    h = _seq_gather(rms_norm(x, lp.ln2, cfg.norm_eps))
    return x + _seq_shard(mlp(lp.mlp, h))


def _head_logits(params: EncDec, x: torch.Tensor, cfg: ArchConfig
                 ) -> torch.Tensor:
    x = _seq_gather(rms_norm(x, params.final_norm, cfg.norm_eps))
    head = (params.embed.t() if cfg.tie_embeddings
            else params.lm_head).to(x.dtype)
    logits = constrain(linear(x, head), "dp", None, "model")
    return mask_vocab_pad(logits, cfg.vocab_size)


def _forward(params: EncDec, tokens: torch.Tensor, cfg: ArchConfig,
             frontend: torch.Tensor, lane: str) -> torch.Tensor:
    enc = encode(params, frontend, cfg, lane=lane)
    x = embedding(params.embed, tokens.long()).to(dtype_of(cfg.dtype))
    # a vocab-split lookup is a partial sum: reduced here, whole
    x = constrain(x, "dp", None, None)
    positions = _positions(x)
    remat = lane == "train" and cfg.remat
    for lp in params.dec_layers:
        x = _remat(_dec_layer, lp, x, enc, cfg, positions, lane, on=remat)
    return _head_logits(params, x, cfg)


@torch.no_grad()
def forward(params: EncDec, tokens: torch.Tensor, cfg: ArchConfig,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full enc-dec forward, serving lane: frames -> encoder; tokens [B, S]
    -> decoder logits [B, S, Vp] in the compute dtype."""
    return _forward(params, tokens, cfg, frontend, "kernel")


def loss_fn(params: EncDec, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: ArchConfig, frontend: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Next-token cross-entropy over the decoder's full logits (the
    reference does not chunk it here), train lane, under autograd."""
    return cross_entropy(_forward(params, tokens, cfg, frontend, "train"),
                         targets)


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"
               ) -> Dict[str, Any]:
    """bf16 ``k``, ``v`` [L, B, max_len, Hkv, hd], zero bf16 encoder states
    ``enc`` [B, F, d] and ``pos`` [B], on ``device`` (default ``"cuda"``).
    ``cfg.kv_quant`` is not read, as in the reference."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "enc": torch.zeros(batch, cfg.frontend_tokens, cfg.d_model,
                           dtype=torch.bfloat16, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(params: EncDec, tokens: torch.Tensor,
                cache: Dict[str, Any], cfg: ArchConfig):
    """One decoder step with the cached encoder states.  tokens: [B, 1].
    Returns (logits [B, 1, Vp], cache); K/V rows and ``pos`` are updated
    in place."""
    x = constrain(embedding(params.embed, tokens.long())
                  .to(dtype_of(cfg.dtype)), "dp", None, None)
    pos = cache["pos"]
    enc = cache["enc"].to(x.dtype)
    for i, lp in enumerate(params.dec_layers):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + decode_attention(lp.attn, h, cfg, cache["k"][i],
                                 cache["v"][i], pos)[0]
        h = rms_norm(x, lp.lnx, cfg.norm_eps)
        x = x + _cross_attention(lp.xattn, h, enc, cfg)
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp(lp.mlp, h)
    cache["pos"] = pos + 1
    return _head_logits(params, x, cfg), cache
