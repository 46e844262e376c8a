"""Language-model assembly for every family but the encoder-decoder.

The port of the reference's ``repro.models.lm``: token embedding (times
``cfg.embed_scale``, gemma's ``sqrt(d_model)``), a plain loop over the
blocks of an ``nn.ModuleList``, the final norm, the tied or separate
head, the logit softcap and the masked vocab padding.  Per-layer sliding
windows are Python ints.  Families:

  dense / vlm  pre-norm GQA attention and gated MLP (gemma2's post
               norms); vlm prepends the frontend's patch embeddings to
               the token stream and takes its loss on the text only
  moe          GQA attention and the top-k MoE FFN (``moe.moe``: the
               expert-parallel ``moe_ep`` in the full-sequence forward
               under an active mesh and ``impl="ep"``, else
               ``moe_dense``; decode always ``moe_dense``)
  hybrid       hymba: attention and the SSM block in parallel on the same
               normed input, ``a = 0.5 * (attn + ssm)``, then a gated MLP
  ssm          xlstm: G = num_layers / slstm_every supergroups, each
               M = slstm_every - 1 pre-norm mLSTM blocks then one pre-norm
               sLSTM block, with no FFN (the reference's ``_xlstm_group``)

The encoder-decoder (``family="audio"``) is ``models.encdec``;
``models.api`` dispatches to it.

Decode caches: K/V per layer (bf16, or int8 under ``cfg.kv_quant``) and
``pos``; hybrid adds ``ssm.{state, conv}``; xlstm's is nested
(``mlstm.{state, conv}`` stacked [G, M, ...], ``slstm.{h, c, n}`` stacked
[G, ...], ``pos``).  Decode updates the cache in place.

Two lanes run the full sequence.  Serving (:func:`forward`, under
``torch.no_grad()``) takes the kernel lane: the hand-written flash and
chunked-mLSTM kernels.  Training (:func:`loss_fn`) takes the train lane:
the reference's XLA paths (``use_pallas=False``, its default) in plain
torch under autograd, each layer checkpointed under ``cfg.remat`` with
``torch.utils.checkpoint``, and the head fused with the cross-entropy in
checkpointed chunks for long sequences.  The SSM scan, the MoE and the
sLSTM are plain torch on both lanes (the reference has no Pallas kernel
for them).

The reference's ``jax.lax.scan`` over stacked layers has no counterpart
here: the port runs eagerly.  Its sharding constraints are the port's
``distrib.sharding.constrain`` at the same points (after the embedding,
sequence parallelism after each block, the vocab-sharded logits): on
DTensor parameters and inputs (``distrib.sharding.device_put``) they
redistribute the activations, on plain tensors they do nothing.  With an
active mesh whose 'model' axis has n > 1 ranks, ``moe.moe`` hands
``moe_ep`` this rank's sequence chunk (the reference's ``shard_map``).
An unknown family raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distrib.sharding import (active_mesh, constrain, embedding,
                                is_dtensor, linear, mesh_axes, on_local,
                                tp_degree)
from ..kernels._cuda import resolve_device
from .attention import (LANES, Attention, attention, decode_attention,
                        decode_attention_quant, init_kv_cache)
from .common import (dense_init, dtype_of, embed_init, mask_vocab_pad,
                     padded_vocab, rms_norm, scalar_in, softcap, weight)
from .mlp import MLP, mlp
from .moe import MoE, local_experts, moe
from .ssm import SSM, init_ssm_cache, ssm_decode_step, ssm_forward
from .xlstm import (MLSTM, SLSTM, init_mlstm_cache, init_slstm_cache,
                    mlstm_decode_step, mlstm_forward, slstm_decode_step,
                    slstm_forward)

# the families this module builds; "audio" is the encoder-decoder
FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder-only "
            f"family of the port ({', '.join(FAMILIES)}); the "
            f"encoder-decoder is family 'audio' (models.encdec, through "
            f"models.api)")


class Block(nn.Module):
    """One pre-norm block: attention, and the MoE for the moe family or
    else a gated MLP; hybrid adds the SSM block beside the attention;
    gemma2's post norms when ``cfg.post_norms``; ``experts`` as for
    :class:`moe.MoE`."""

    def __init__(self, cfg: ArchConfig, *, device=None, experts=None):
        super().__init__()
        self.ln1 = weight((cfg.d_model,), device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = weight((cfg.d_model,), device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, device=device, experts=experts)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)
        if cfg.family == "hybrid":
            self.ssm = SSM(cfg.d_model, cfg.ssm, device=device)
        if cfg.post_norms:
            self.pn1 = weight((cfg.d_model,), device)
            self.pn2 = weight((cfg.d_model,), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "Block":
        for name in ("ln1", "ln2", "pn1", "pn2"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        self.attn.reset_parameters(gen)
        for name in ("moe", "mlp", "ssm"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(gen)
        return self


def xlstm_groups(cfg: ArchConfig):
    """(G supergroups, M mLSTM blocks in each) of an xlstm config."""
    every = cfg.xlstm.slstm_every
    return cfg.num_layers // every, every - 1


class XLSTMGroup(nn.Module):
    """One supergroup: M mLSTM blocks with their pre-norms ``ln_m`` [M, d],
    then one sLSTM block with its pre-norm ``ln_s`` [d]."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        _, M = xlstm_groups(cfg)
        self.mlstm = nn.ModuleList(MLSTM(cfg, device=device)
                                   for _ in range(M))
        self.ln_m = weight((M, cfg.d_model), device)
        self.slstm = SLSTM(cfg, device=device)
        self.ln_s = weight((cfg.d_model,), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "XLSTMGroup":
        for blk in self.mlstm:
            blk.reset_parameters(gen)
        self.ln_m.zero_()
        self.slstm.reset_parameters(gen)
        self.ln_s.zero_()
        return self


class LM(nn.Module):
    """The parameters of an LM (f32, ``param_dtype``): ``layers`` of
    :class:`Block`, or ``groups`` of :class:`XLSTMGroup` for ssm.
    ``experts=(lo, hi)``: each MoE layer holds only those experts."""

    def __init__(self, cfg: ArchConfig, *, device=None, experts=None):
        super().__init__()
        check_family(cfg)
        self.embed = weight((padded_vocab(cfg.vocab_size), cfg.d_model),
                            device)
        self.final_norm = weight((cfg.d_model,), device)
        if not cfg.tie_embeddings:
            self.lm_head = weight((cfg.d_model,
                                   padded_vocab(cfg.vocab_size)), device)
        if cfg.family == "ssm":
            G, _ = xlstm_groups(cfg)
            self.groups = nn.ModuleList(XLSTMGroup(cfg, device=device)
                                        for _ in range(G))
        else:
            self.layers = nn.ModuleList(
                Block(cfg, device=device, experts=experts)
                for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "LM":
        """The reference's initializers (uniform ``1/sqrt(fan_in)`` dense,
        ``0.02`` normal embedding, zero norms and biases), drawn from
        ``gen``."""
        self.embed.copy_(embed_init(gen, *self.embed.shape))
        self.final_norm.zero_()
        if hasattr(self, "lm_head"):
            self.lm_head.copy_(dense_init(gen, *self.lm_head.shape))
        for blk in (self.groups if hasattr(self, "groups") else self.layers):
            blk.reset_parameters(gen)
        return self


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Per-layer sliding-window sizes (0 = global causal)."""
    L = cfg.num_layers
    if cfg.local_global_pattern and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(L)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * L
    return [0] * L


def init_params(gen: torch.Generator, cfg: ArchConfig, *, device="cuda",
                mesh=None) -> LM:
    """Seeded weights (:meth:`LM.reset_parameters`) on ``device`` (default
    ``"cuda"``, which raises without a card; pass ``"cpu"`` for the plain
    versions of the kernels).  With a ``mesh`` whose 'model' axis has
    several ranks, each MoE layer holds only this rank's experts
    (:func:`moe.local_experts`), with the values the whole layer would
    have.  That is for the forward: the train step's global-norm clip
    reads only the gradients a rank holds, so training keeps every expert
    on every rank (``launch.train`` passes no mesh here)."""
    return LM(cfg, device=resolve_device(device),
              experts=local_experts(cfg, mesh)).reset_parameters(gen)


# -------------------------------------------------------------- block bodies
def _block(p: Block, x: torch.Tensor, cfg: ArchConfig,
           attend: Callable[[Attention, torch.Tensor], torch.Tensor],
           mix: Optional[Callable[[SSM, torch.Tensor], torch.Tensor]] = None,
           mesh=None) -> torch.Tensor:
    """One block; ``attend(p.attn, h)`` is full-sequence attention in the
    forward and one-token attention over the cache in decode, and
    ``mix(p.ssm, h)`` the hybrid family's SSM block, likewise.  ``mesh``
    is the active mesh in the forward (the MoE's dispatch) and ``None`` in
    decode (dense MoE, as the reference's decode)."""
    x = _seq_shard(x)
    h = _seq_gather(rms_norm(x, p.ln1, cfg.norm_eps))
    a = attend(p.attn, h)
    if cfg.family == "hybrid":
        a = 0.5 * (a + mix(p.ssm, h))    # hymba: parallel attn+SSM fusion
    if cfg.post_norms:
        a = rms_norm(a, p.pn1, cfg.norm_eps)
    x = x + _seq_shard(a)
    h = _seq_gather(rms_norm(x, p.ln2, cfg.norm_eps))
    f = moe(p.moe, h, cfg, mesh=mesh) if cfg.family == "moe" \
        else mlp(p.mlp, h)
    if cfg.post_norms:
        f = rms_norm(f, p.pn2, cfg.norm_eps)
    return x + _seq_shard(f)


def _seq_gather(h: torch.Tensor) -> torch.Tensor:
    """A normed activation whole over the sequence for the projections
    (the all-gather that XLA inserts after the reference's sequence
    parallelism); a plain tensor as it is."""
    return constrain(h, "dp", None, None)


def _seq_shard(x: torch.Tensor) -> torch.Tensor:
    """The reference's Megatron-style sequence parallelism: between blocks
    the residual stream lives S-sharded over 'model' (with the
    reference's threshold of 0 bytes, whenever S divides the TP degree
    and the policy is not pure DP).  The block scatters each branch's
    output into that layout before the residual add (the reduce-scatter
    after a row-parallel projection), so both sides of every add share
    one layout and the backward returns each gradient in the layout its
    projection made."""
    if tp_degree() == 1 or x.shape[1] % tp_degree():
        return x
    return constrain(x, "dp", "model", None)


def _embed(params: LM, tokens: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    cdt = dtype_of(cfg.dtype)
    # a vocab-split lookup is a partial sum: reduced here, whole
    x = constrain(embedding(params.embed, tokens.long()), "dp", None, None)
    x = x.to(cdt)
    if cfg.embed_scale != 1.0:
        x = x * scalar_in(cfg.embed_scale, cdt)
    return x


# ------------------------------------------------------------------- forward
def _remat(fn: Callable, *args, on: bool):
    """``fn(*args)``, checkpointed when ``on`` (the reference's
    ``jax.checkpoint`` per layer under ``cfg.remat``): the backward
    recomputes the block instead of keeping its activations."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _dense_layer(blk: Block, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, w: int, lane: str) -> torch.Tensor:
    return _block(blk, x, cfg, lambda pa, h: attention(
        pa, h, cfg, positions, window=w, lane=lane),
        lambda ps, h: ssm_forward(ps, h, cfg), mesh=active_mesh())


def _mlstm_layer(blk: MLSTM, ln: torch.Tensor, x: torch.Tensor,
                 cfg: ArchConfig, lane: str) -> torch.Tensor:
    return x + mlstm_forward(blk, rms_norm(x, ln, cfg.norm_eps), cfg,
                             lane=lane)


def _slstm_layer(blk: SLSTM, ln: torch.Tensor, x: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    return x + slstm_forward(blk, rms_norm(x, ln, cfg.norm_eps), cfg)


def hidden_forward(params: LM, tokens: torch.Tensor, cfg: ArchConfig,
                   frontend: Optional[torch.Tensor] = None, *,
                   lane: str = "kernel") -> torch.Tensor:
    """tokens: [B, S] int.  Returns final hidden states [B, S, D] (after
    the final norm).  ``frontend`` [B, F, D] (the vlm family's patch
    embeddings) is cast to the compute dtype and prepended to the token
    embeddings, so S counts its F positions; the other families ignore
    it, as the reference does.

    ``lane="kernel"`` (serving) runs attention and the mLSTM through the
    hand-written kernels, which have no backward and raise on inputs that
    require grad: :func:`forward` calls it under ``torch.no_grad()``.
    ``lane="train"`` (:func:`loss_fn`) runs the reference's XLA paths in
    plain torch under autograd, each layer checkpointed when
    ``cfg.remat``.  The caller picks the lane; nothing falls back."""
    if lane not in LANES:
        raise ValueError(f"lane must be one of {LANES}, got {lane!r}")
    remat = lane == "train" and cfg.remat
    x = _embed(params, tokens, cfg)
    if cfg.family == "vlm" and frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    x = constrain(x, "dp", None, None)
    if cfg.family == "ssm":
        for grp in params.groups:
            for blk, ln in zip(grp.mlstm, grp.ln_m):
                x = _remat(_mlstm_layer, blk, ln, x, cfg, lane, on=remat)
            x = _remat(_slstm_layer, grp.slstm, grp.ln_s, x, cfg, on=remat)
        return rms_norm(x, params.final_norm, cfg.norm_eps)
    # [1, S]: every row's positions are 0..S-1 (broadcast over the batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    for blk, w in zip(params.layers, layer_windows(cfg)):
        x = _remat(_dense_layer, blk, x, cfg, positions, w, lane, on=remat)
    return _seq_gather(rms_norm(x, params.final_norm, cfg.norm_eps))


def _head(params: LM, cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    return (params.embed.t() if cfg.tie_embeddings
            else params.lm_head).to(dtype)


def _logits(params: LM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    logits = linear(x, _head(params, cfg, x.dtype))
    logits = constrain(logits, "dp", None, "model")   # vocab-sharded logits
    if cfg.logit_softcap > 0:
        logits = softcap(logits.float(), cfg.logit_softcap)
    return mask_vocab_pad(logits, cfg.vocab_size)


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: ArchConfig,
            frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns logits [B, S, Vp] (f32 under a logit softcap, else the
    compute dtype)."""
    return _logits(params, hidden_forward(params, tokens, cfg, frontend), cfg)


# ---------------------------------------------------------------------- loss
def _token_nll(logits: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """logsumexp minus the target's logit, per token, in f32.  On DTensor
    logits (vocab split over 'model') no rank gathers the logits, as in
    the reference's vocab-sharding-friendly form: the max-shifted
    logsumexp reduces over the split vocab, and each rank picks the
    target's logit from its own vocab shard (a partial sum over
    'model')."""
    logits = logits.float()
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1) \
            - logits.gather(-1, targets.long()[..., None])[..., 0]
    lse = _LogSumExp.apply(logits)
    split = tp_degree() != 1
    tgt = on_local(_pick_target, (logits, targets.long()),
                   (("dp", None, "model"), ("dp", None)), ("dp", None),
                   targets.shape, out_partial=("model",) if split else ())
    return lse - tgt


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(x, -1)`` in ops a DTensor splits over the vocab:
    the forward is the max-shifted sum of exponentials (the steps of
    ``torch.logsumexp``), the backward ``grad * exp(x - lse)``, the
    formula of its backward.  Autograd through the composite form would
    take ``grad / sum * exp(x - max)`` instead, whose float32 rounding
    differs from the plain lane's; under bf16 copies of the weights that
    difference flips bf16 roundings in the logits' gradient and so in
    every gradient before it.  With this backward the DTensor lane's
    gradients at one rank are the plain lane's, bit for bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        m = x.amax(dim=-1, keepdim=True)
        lse = (x - m).exp().sum(dim=-1).log() + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        x, lse = ctx.saved_tensors
        return grad[..., None] * (x - lse[..., None]).exp()


def _pick_target(logits: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """This rank's part of each token's target logit: logits [b, s, V_loc]
    hold vocab ids ``off .. off + V_loc - 1`` of the 'model' rank; a
    target outside them gives 0 (a partial sum over 'model')."""
    mesh = active_mesh()
    V_loc = logits.shape[-1]
    off = 0
    if tp_degree() != 1 and mesh is not None \
            and mesh_axes(mesh).get("model", 1) > 1:
        off = mesh.get_local_rank("model") * V_loc
    idx = targets - off
    mine = (idx >= 0) & (idx < V_loc)
    got = logits.gather(-1, idx.clamp(0, V_loc - 1)[..., None])[..., 0]
    return torch.where(mine, got, 0.0)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    return _token_nll(logits, targets).mean()


CE_CHUNK = 512


def _ce_chunk_sum(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor,
                  cap: float, vocab: int) -> torch.Tensor:
    logits = constrain(linear(xc, head), "dp", None, "model").float()
    if cap > 0:
        logits = softcap(logits, cap)
    return _token_nll(mask_vocab_pad(logits, vocab), tc).sum()


def chunked_head_ce(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, cap: float, vocab: int,
                    chunk: int = CE_CHUNK) -> torch.Tensor:
    """Fused final projection + CE over sequence chunks of ``chunk``: never
    forms the whole [B, S, V] logits.  Each chunk is checkpointed (the
    reference's ``jax.checkpoint`` on its scan body), so the backward
    re-forms one chunk's logits at a time.  The chunk sums add up in
    order, from 0, as the reference's scan carries them."""
    B, S, _ = x.shape
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        total = total + checkpoint(
            _ce_chunk_sum, x[:, c:c + chunk], head, targets[:, c:c + chunk],
            cap, vocab, use_reentrant=False)
    return total / (B * S)


def loss_fn(params: LM, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: ArchConfig, frontend: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Next-token cross-entropy averaged over target tokens (a 0-dim f32
    tensor), through the training lane of :func:`hidden_forward`.  The
    head and CE are chunked (:func:`chunked_head_ce`) when S is a multiple
    of :data:`CE_CHUNK` above it, as in the reference.  For vlm the
    frontend positions are dropped before the head: the loss is on the
    text only."""
    x = hidden_forward(params, tokens, cfg, frontend, lane="train")
    if frontend is not None and cfg.family == "vlm":
        x = x[:, frontend.shape[1]:, :]               # loss on text only
    S = x.shape[1]
    if S % CE_CHUNK == 0 and S > CE_CHUNK and not cfg.cost_analysis_mode:
        return chunked_head_ce(x, _head(params, cfg, x.dtype), targets,
                               cfg.logit_softcap, cfg.vocab_size)
    return cross_entropy(_logits(params, x, cfg), targets)


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"
               ) -> Dict[str, Any]:
    """Decode state on ``device`` (default ``"cuda"``, as
    :func:`init_params`).  Dense: bf16 ``k``, ``v`` [L, B, max_len, Hkv,
    hd] and the int32 per-sequence position ``pos`` [B]; under
    ``cfg.kv_quant`` int8 ``k``, ``v`` with bf16 ``k_scale``, ``v_scale``
    [L, B, max_len, Hkv].  Hybrid adds ``ssm.state`` f32 [L, B, N, H,
    P] and ``ssm.conv`` bf16 [L, B, K-1, d_inner].  Ssm: the
    recurrent states (``max_len`` unused) ``mlstm.state`` f32 [G, M, B, H,
    P, P+1], ``mlstm.conv`` bf16 [G, M, B, K-1, d_inner], ``slstm.{h, c,
    n}`` f32 [G, B, H, d/H], and ``pos``."""
    check_family(cfg)
    device = resolve_device(device)
    if cfg.family == "ssm":
        G, M = xlstm_groups(cfg)
        m = init_mlstm_cache(cfg, batch, G * M, device=device)
        return {"mlstm": {name: a.reshape(G, M, *a.shape[1:])
                          for name, a in m.items()},
                "slstm": init_slstm_cache(cfg, batch, G, device=device),
                "pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    cache = init_kv_cache(cfg, batch, max_len, cfg.num_layers,
                          device=device)
    if cfg.family == "hybrid":
        cache["ssm"] = init_ssm_cache(cfg, batch, cfg.num_layers,
                                      device=device)
    return cache


def _decode_attend(cache: Dict[str, Any], i: int, w: int,
                   pos: torch.Tensor, cfg: ArchConfig) -> Callable:
    """Layer i's one-token attention over its K/V rows (int8 under
    ``cfg.kv_quant``), written in place."""
    if cfg.kv_quant:
        return lambda pa, h: decode_attention_quant(
            pa, h, cfg, cache["k"][i], cache["v"][i], cache["k_scale"][i],
            cache["v_scale"][i], pos, window=w)[0]
    return lambda pa, h: decode_attention(
        pa, h, cfg, cache["k"][i], cache["v"][i], pos, window=w)[0]


def _decode_mix(cache: Dict[str, Any], i: int, cfg: ArchConfig
                ) -> Optional[Callable]:
    """Layer i's hybrid SSM step on its state and conv window, in place
    (``None`` for the other families)."""
    if cfg.family != "hybrid":
        return None
    st, cv = cache["ssm"]["state"][i], cache["ssm"]["conv"][i]
    return lambda ps, h: ssm_decode_step(ps, h, cfg, st, cv)[0]


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor,
                cache: Dict[str, Any], cfg: ArchConfig):
    """One decode step.  tokens: [B, 1] int.  Returns (logits [B, 1, Vp],
    cache); the cache's K/V rows, recurrent states and ``pos`` are
    updated in place (the reference donates its cache buffers), so the
    returned dict is the one passed in."""
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]
    if cfg.family == "ssm":
        mc, sc = cache["mlstm"], cache["slstm"]
        for g, grp in enumerate(params.groups):
            for m, (blk, ln) in enumerate(zip(grp.mlstm, grp.ln_m)):
                y, _, _ = mlstm_decode_step(
                    blk, rms_norm(x, ln, cfg.norm_eps), cfg,
                    mc["state"][g, m], mc["conv"][g, m])
                x = x + y
            y, _, _, _ = slstm_decode_step(
                grp.slstm, rms_norm(x, grp.ln_s, cfg.norm_eps), cfg,
                sc["h"][g], sc["c"][g], sc["n"][g])
            x = x + y
    else:
        for i, (blk, w) in enumerate(zip(params.layers, layer_windows(cfg))):
            x = _block(blk, x, cfg, _decode_attend(cache, i, w, pos, cfg),
                       _decode_mix(cache, i, cfg))
    cache["pos"] = pos + 1
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, x, cfg), cache
