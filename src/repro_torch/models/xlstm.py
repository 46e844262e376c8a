"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential recurrence).

The port of the reference's ``repro.models.xlstm``, with its numerics and
its deviation from the paper (a bounded sigmoid input gate, so the chunked
form needs no running max-stabiliser).  The mLSTM recurrence
C_t = f_t C_{t-1} + i_t v_t k_t^T with readout
y_t = (C_t^T q_t) / max(|n_t^T q_t|, 1) runs over the whole sequence in
:func:`mlstm_forward` through the chunked-mLSTM dispatcher
(``kernels.mlstm_chunk.ops``): the hand-written CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor.  Like the port's attention it
does not read ``cfg.use_pallas``.  The kernel has no backward (nor has the
reference's Pallas kernel), so training takes ``_ssd_scan_perhead``, the
reference's XLA path, in plain torch under autograd (``lane="train"``).

The sLSTM's time loop is sequential (the reference's ``lax.scan``, with no
Pallas kernel behind it): here a Python loop of plain torch ops, one step
per token.

Decode updates the caller's state tensors in place (the reference donates
its cache).  The mLSTM's conv window is cached in bfloat16 whatever the
compute dtype, as the reference caches it, so decode rounds the last
``conv_kernel - 1`` inputs through bf16 and the full-sequence forward
does not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distrib.sharding import (HEAD_DIMS, is_dtensor, linear, on_local,
                                pointwise, reshape)
from ..kernels._cuda import resolve_device
from ..kernels.mlstm_chunk import ops as mc_ops
from .common import dense_init, silu, weight
from .ssm import _causal_conv


def mlstm_dims(cfg: ArchConfig):
    """(d_inner, H, P) of an mLSTM block.  P is mlstm_expand * d_model / H
    (1024 at xlstm-1.3b); the config's ``head_dim`` (512) is not read on
    this path, as in the reference (``xlstm.py:48-50``)."""
    d_inner = cfg.xlstm.mlstm_expand * cfg.d_model
    H = cfg.num_heads
    return d_inner, H, d_inner // H


def _inv_sqrt(P: int) -> float:
    """The reference's ``1 / sqrt(P)`` in float32, as a Python float."""
    return torch.tensor(float(P)).sqrt().reciprocal().item()


# ---------------------------------------------------------------------- mLSTM
class MLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        d_inner, H, _ = mlstm_dims(cfg)
        self.w_in = weight((d, 2 * d_inner), device)         # u and gate z
        self.conv_w = weight((cfg.xlstm.conv_kernel, d_inner), device)
        self.w_q = weight((d_inner, d_inner), device)
        self.w_k = weight((d_inner, d_inner), device)
        self.w_if = weight((d_inner, 2 * H), device)         # i and f gates
        self.if_bias = weight((2 * H,), device)
        self.w_out = weight((d_inner, d), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "MLSTM":
        for w in (self.w_in, self.w_q, self.w_k, self.w_if, self.w_out):
            w.copy_(dense_init(gen, *w.shape))
        self.conv_w.copy_(torch.randn(*self.conv_w.shape, generator=gen,
                                      device=gen.device).mul_(0.1))
        self.if_bias.zero_()
        return self


def mlstm_forward(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
                  lane: str = "kernel") -> torch.Tensor:
    """x: [B, S, d_model] -> [B, S, d_model].  ``lane="kernel"`` runs the
    recurrence through the chunked-mLSTM kernel (no backward: it raises on
    inputs that require grad); ``lane="train"`` through
    :func:`_ssd_scan_perhead` under autograd, the reference's path with
    ``use_pallas=False``."""
    d_inner, H, P = mlstm_dims(cfg)
    B, S, _ = x.shape
    xz = linear(x, p.w_in.to(x.dtype))
    u, z = xz.chunk(2, dim=-1)
    u = silu(_causal_conv(u, p.conv_w.to(x.dtype)))
    q = reshape(linear(u, p.w_q.to(x.dtype)), B, S, H, P)
    k = reshape(linear(u, p.w_k.to(x.dtype)), B, S, H, P)
    v = reshape(u, B, S, H, P)
    gif = (linear(u, p.w_if.to(x.dtype))).float() + p.if_bias
    ig = torch.sigmoid(gif[..., :H])                           # [B,S,H]
    la = pointwise(F.logsigmoid, gif[..., H:])                 # log f <= 0
    # the normaliser: the same recurrence with a ones column appended to v,
    # so the kernel's value width is Pv = P + 1 (1025 at xlstm-1.3b)
    vv = torch.cat([v.float(), v.new_ones(B, S, H, 1, dtype=torch.float32)],
                   dim=-1)
    # the readout sum_{s<=t} exp(cum_t - cum_s) ig_s (q_t.k_s) vv_s plus
    # the carried state, f32, whatever cfg.use_pallas says: in the kernel
    # lane the device decides between the kernel and its plain version
    if lane == "kernel":
        def core(*a):
            return mc_ops.mlstm_chunk(*a, chunk=cfg.xlstm.chunk)
    elif lane == "train":
        def core(*a):
            return _ssd_scan_perhead(*a, cfg.xlstm.chunk)
    else:
        raise ValueError(f"lane must be 'kernel' or 'train', got {lane!r}")
    args = (q.float() * _inv_sqrt(P), k.float(), vv, ig, la)
    if is_dtensor(q):
        # each rank's own heads, on plain tensors
        num_den = on_local(core, args, (HEAD_DIMS,) * 3
                           + (HEAD_DIMS[:3],) * 2, HEAD_DIMS, vv.shape)
    else:
        num_den = core(*args)
    num, den = num_den[..., :P], num_den[..., P:]
    y = num / torch.clamp(den.abs(), min=1.0)
    y = reshape(y, B, S, d_inner).to(x.dtype)
    y = y * silu(z)
    return linear(y, p.w_out.to(x.dtype))


def _ssd_scan_perhead(q, k, v, ig, la, chunk: int) -> torch.Tensor:
    """The reference's XLA path (``ssd_scan`` generalised to per-head
    (B, C) = (k, q) and data-dependent log-decay ``la`` [B,S,H]) in plain
    torch: chunk-local readout, per-chunk state contributions, a
    sequential pass over the chunks, the carried readout.  Shapes: q, k
    [B,S,H,P]; v [B,S,H,Pv].  The training lane of :func:`mlstm_forward`
    (differentiable), and what the tests hold the kernel's dispatcher
    against."""
    Bb, S, H, P = q.shape
    Pv = v.shape[-1]
    c = min(chunk, S)
    nC = S // c
    if nC * c != S:
        raise ValueError(f"S = {S} must be a multiple of chunk = {c}")
    q_ = q.reshape(Bb, nC, c, H, P)
    k_ = k.reshape(Bb, nC, c, H, P)
    v_ = v.reshape(Bb, nC, c, H, Pv)
    ig_ = ig.reshape(Bb, nC, c, H)
    cum = torch.cumsum(la.reshape(Bb, nC, c, H), dim=2)       # [B,nC,c,H]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nC,c,c,H]
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    L = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                   float("-inf")))
    scores = torch.einsum("bnthp,bnshp->bntsh", q_, k_) * L
    iv = ig_[..., None] * v_                                   # [B,nC,c,H,Pv]
    y_local = torch.einsum("bntsh,bnshp->bnthp", scores, iv)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nC,c,H]
    contrib = torch.einsum("bnshk,bnshp->bnhkp", k_,
                           iv * decay_to_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1])                     # [B,nC,H]
    state = torch.zeros(Bb, H, P, Pv, dtype=torch.float32, device=q.device)
    prev = []
    for n in range(nC):
        prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + contrib[:, n]
    prev_states = torch.stack(prev, dim=1)                     # [B,nC,H,P,Pv]
    y_carry = torch.einsum("bnthp,bnhpw->bnthw", q_, prev_states)
    y = y_local + y_carry * torch.exp(cum)[..., None]
    return y.reshape(Bb, S, H, Pv)


def init_mlstm_cache(cfg: ArchConfig, batch: int, n_mlstm: int, *,
                     device="cuda"):
    """f32 matrix states [n, B, H, P, P+1] and the bf16 conv windows
    [n, B, K-1, d_inner] (bf16 whatever the compute dtype, as the
    reference keeps them)."""
    device = resolve_device(device)
    d_inner, H, P = mlstm_dims(cfg)
    return {
        "state": torch.zeros(n_mlstm, batch, H, P, P + 1,
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(n_mlstm, batch, cfg.xlstm.conv_kernel - 1,
                            d_inner, dtype=torch.bfloat16, device=device),
    }


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
                      state: torch.Tensor, conv_buf: torch.Tensor):
    """x: [B,1,d]; state: [B,H,P,P+1] f32; conv_buf: [B,K-1,d_inner] bf16.
    Both are updated in place and returned: (y [B,1,d], state, conv_buf)."""
    d_inner, H, P = mlstm_dims(cfg)
    xz = linear(x, p.w_in.to(x.dtype))
    u, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv_buf.to(u.dtype), u], dim=1)       # [B,K,d_inner]
    u_c = silu(torch.einsum("bkd,kd->bd", window,
                            p.conv_w.to(u.dtype)))[:, None, :]
    conv_buf.copy_(window[:, 1:, :])                           # rounds to bf16
    q = reshape(linear(u_c, p.w_q.to(x.dtype)), -1, H, P).float()
    k = reshape(linear(u_c, p.w_k.to(x.dtype)), -1, H, P).float()
    v = reshape(u_c, -1, H, P).float()
    gif = (linear(u_c, p.w_if.to(x.dtype))).float()[:, 0] + p.if_bias
    ig = torch.sigmoid(gif[..., :H])
    fg = torch.sigmoid(gif[..., H:])
    vv = torch.cat([v, v.new_ones(v.shape[0], H, 1)], dim=-1)
    state.mul_(fg[:, :, None, None]).add_(
        ig[:, :, None, None] * (k[..., :, None] * vv[..., None, :]))
    out = torch.einsum("bhp,bhpw->bhw", q * _inv_sqrt(P), state)
    num, den = out[..., :P], out[..., P:]
    y = num / torch.clamp(den.abs(), min=1.0)
    y = reshape(y, -1, 1, d_inner).to(x.dtype)
    y = y * silu(z)
    return linear(y, p.w_out.to(x.dtype)), state, conv_buf


# ---------------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        P = d // H
        self.w_gates = weight((d, 4 * d), device)             # i, f, z, o
        self.r_gates = weight((H, P, 4 * P), device)
        self.b_gates = weight((4 * d,), device)
        self.w_out = weight((d, d), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "SLSTM":
        H, P, _ = self.r_gates.shape
        self.w_gates.copy_(dense_init(gen, *self.w_gates.shape))
        self.r_gates.copy_(torch.randn(H, P, 4 * P, generator=gen,
                                       device=gen.device)
                           .mul_(1.0 / P ** 0.5))
        self.b_gates.zero_()
        self.w_out.copy_(dense_init(gen, *self.w_out.shape))
        return self


def _slstm_cell(g: torch.Tensor, c: torch.Tensor, n: torch.Tensor, P: int):
    """One step's gates g [B,H,4P] (i, f, z, o) on the cell c and the
    normaliser n: returns (h, c, n)."""
    i = torch.sigmoid(g[..., :P])
    f = torch.sigmoid(g[..., P:2 * P])
    zin = torch.tanh(g[..., 2 * P:3 * P])
    o = torch.sigmoid(g[..., 3 * P:])
    c = f * c + i * zin
    n = f * n + i
    return o * c / torch.clamp(n, min=1.0), c, n


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    """Sequential scalar-memory LSTM with block-diagonal recurrence: one
    step of plain torch ops per token (the reference's ``lax.scan``)."""
    B, S, d = x.shape
    H = cfg.num_heads
    P = d // H
    wx = linear(x, p.w_gates.to(x.dtype)).float() + p.b_gates   # [B,S,4d]
    wx = reshape(wx, B, S, H, 4 * P)
    r = p.r_gates.float()                                      # once a call
    if is_dtensor(wx):
        # the recurrence is per head: each rank loops over its own heads
        hs = on_local(_slstm_scan, (wx, r), (HEAD_DIMS, ("model", None,
                                                         None)),
                      HEAD_DIMS, (B, S, H, P))
    else:
        hs = _slstm_scan(wx, r)
    y = reshape(hs, B, S, d).to(x.dtype)
    return linear(y, p.w_out.to(x.dtype))


def _slstm_scan(wx: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The sLSTM's time loop: wx [B, S, H, 4P] f32 input gates, r [H, P,
    4P] the block-diagonal recurrence -> h [B, S, H, P].  (The dry run,
    ``launch.dryrun``, stands one counted step in for this loop.)"""
    B, S, H, P4 = wx.shape
    P = P4 // 4
    h, c, n = (wx.new_zeros(B, H, P) for _ in range(3))
    hs = []
    for t in range(S):
        rec = torch.einsum("bhp,hpq->bhq", h, r)
        h, c, n = _slstm_cell(wx[:, t] + rec, c, n, P)
        hs.append(h)
    return torch.stack(hs, dim=1)


def init_slstm_cache(cfg: ArchConfig, batch: int, n_slstm: int, *,
                     device="cuda"):
    """f32 h, c, n [n, B, H, P], three separate tensors (decode writes them
    in place)."""
    device = resolve_device(device)
    H = cfg.num_heads
    P = cfg.d_model // H
    return {name: torch.zeros(n_slstm, batch, H, P, device=device)
            for name in ("h", "c", "n")}


def slstm_decode_step(p: SLSTM, x: torch.Tensor, cfg: ArchConfig,
                      h: torch.Tensor, c: torch.Tensor, n: torch.Tensor):
    """x: [B,1,d]; h, c, n: [B,H,P], updated in place.  Returns
    (y [B,1,d], h, c, n)."""
    B, _, d = x.shape
    H = cfg.num_heads
    P = d // H
    wx = (linear(x, p.w_gates.to(x.dtype))).float()[:, 0] + p.b_gates
    rec = torch.einsum("bhp,hpq->bhq", h, p.r_gates.float())
    h2, c2, n2 = _slstm_cell(reshape(wx, B, H, 4 * P) + rec, c, n, P)
    h.copy_(h2)
    c.copy_(c2)
    n.copy_(n2)
    y = reshape(h, B, 1, d).to(x.dtype)
    return linear(y, p.w_out.to(x.dtype)), h, c, n
