"""Mamba-2 (SSD)-style selective SSM block, used inside hymba's parallel
attention + SSM heads, and the causal depthwise convolution that xlstm's
mLSTM block shares.

The port of the reference's ``repro.models.ssm``.  The full sequence runs
the SSD *chunked* scan (:func:`ssd_scan`): within a chunk of length c the
recurrence is a decay-masked attention-like product per head; chunk
boundary states carry across chunks in a short sequential loop (the
reference's ``lax.scan``).  The scan runs in f32.  The reference has no
Pallas kernel here, so this is plain torch, on both lanes.

One departure, a repair: the reference forms ``exp(cum[t] - cum[s])`` for
every (t, s) of a chunk and then drops the entries above the diagonal
(``jnp.where``).  There the difference is positive and, at chunk 256,
overflows f32 (about 176 at dt = softplus(0), a = -1), so the forward is
right but the backward is 0 * inf = NaN.  The port masks before the
exponential, so the dropped entries are exp(-inf) = 0 with a zero
gradient; every kept entry is the reference's.

Decode (:func:`ssm_decode_step`) updates the caller's state and conv
window in place (the reference donates its cache).  The conv window is
cached in bfloat16 whatever the compute dtype, as the reference caches
it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, SSMConfig
from ..distrib.sharding import (HEAD_DIMS, is_dtensor, linear, on_local,
                                reshape)
from ..kernels._cuda import resolve_device
from .common import dense_init, silu, weight


def _heads_for(d_inner: int) -> Tuple[int, int]:
    """Split d_inner into (H heads, P channels) with P a multiple of 8."""
    P = 64
    while d_inner % P and P > 8:
        P //= 2
    return d_inner // P, P


class SSM(nn.Module):
    """``w_in`` [d, 2 d_inner] (u and the gate z), ``conv_w`` [K, d_inner],
    ``w_bc`` [d_inner, 2N] (B and C, shared by the heads), ``w_dt``
    [d_inner, H], ``dt_bias`` and ``a_log`` [H] (A = -exp(a_log)),
    ``d_skip`` [d_inner] and ``w_out`` [d_inner, d]."""

    def __init__(self, d_model: int, ssm: SSMConfig, *, device=None):
        super().__init__()
        d_inner = ssm.expand * d_model
        H, _ = _heads_for(d_inner)
        N = ssm.state_dim
        self.w_in = weight((d_model, 2 * d_inner), device)
        self.conv_w = weight((ssm.conv_kernel, d_inner), device)
        self.w_bc = weight((d_inner, 2 * N), device)
        self.w_dt = weight((d_inner, H), device)
        self.dt_bias = weight((H,), device)
        self.a_log = weight((H,), device)
        self.d_skip = weight((d_inner,), device)
        self.w_out = weight((d_inner, d_model), device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> "SSM":
        """``init_ssm``'s initializers: uniform ``1/sqrt(fan_in)`` matrices,
        a 0.1 normal conv, zero ``dt_bias`` and ``a_log``, unit skip."""
        for w in (self.w_in, self.w_bc, self.w_dt, self.w_out):
            w.copy_(dense_init(gen, *w.shape))
        self.conv_w.copy_(torch.randn(*self.conv_w.shape, generator=gen,
                                      device=gen.device).mul_(0.1))
        self.dt_bias.zero_()
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        return self


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D]; w: [K, D] depthwise causal conv, summed tap by tap in
    the reference's order.  On DTensors each rank convolves its own rows
    and channels (the sequence whole)."""
    if is_dtensor(x):
        dims = ("dp", None, "model")
        return on_local(_causal_conv, (x, w), (dims, (None, "model")), dims,
                        x.shape)
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + x.shape[1], :] * w[k][None, None, :]
    return out


def ssd_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """SSD chunked scan.

    u:  [Bb, S, H, P]   inputs per head
    dt: [Bb, S, H]      positive step sizes
    a:  [H]             negative per-head decay rates (A = -exp(a_log))
    B, C: [Bb, S, N]    shared input/output projections
    Returns y: [Bb, S, H, P].
    """
    Bb, S, H, P = u.shape
    N = B.shape[-1]
    c = min(chunk, S)
    nC = S // c
    assert nC * c == S, f"seq {S} must divide chunk {c}"

    u_ = u.reshape(Bb, nC, c, H, P)
    dt_ = dt.reshape(Bb, nC, c, H)
    B_ = B.reshape(Bb, nC, c, N)
    C_ = C.reshape(Bb, nC, c, N)

    la = dt_ * a[None, None, None, :]            # log-decay per step (<=0)
    cum = torch.cumsum(la, dim=2)                # [Bb,nC,c,H]

    # ---- intra-chunk: decay-masked attention-like product ----
    # L[t,s] = exp(cum[t] - cum[s]) for s <= t, masked before the
    # exponential (the module docstring's repair)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [Bb,nC,c,c,H]
    causal = torch.ones(c, c, dtype=torch.bool, device=u.device).tril()
    L = diff.masked_fill(~causal[None, None, :, :, None],
                         float("-inf")).exp()
    scores = torch.einsum("bntk,bnsk->bnts", C_, B_)           # [Bb,nC,c,c]
    scores = scores[..., None] * L                             # [Bb,nC,c,c,H]
    du = dt_[..., None] * u_                                   # [Bb,nC,c,H,P]
    y_local = torch.einsum("bntsh,bnshp->bnthp", scores, du)

    # ---- chunk states and cross-chunk carry ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [Bb,nC,c,H]
    state_contrib = torch.einsum("bnsk,bnshp->bnkhp", B_,
                                 du * decay_to_end[..., None])  # [Bb,nC,N,H,P]
    chunk_decay = torch.exp(cum[:, :, -1]).float()             # [Bb,nC,H]
    state_contrib = state_contrib.float()
    state = torch.zeros(Bb, N, H, P, dtype=torch.float32, device=u.device)
    prev = []
    for n in range(nC):
        prev.append(state)
        state = state * chunk_decay[:, n, None, :, None] + state_contrib[:, n]
    prev_states = torch.stack(prev, dim=1)                     # [Bb,nC,N,H,P]

    carry_decay = torch.exp(cum)                          # from chunk start
    y_carry = torch.einsum("bntk,bnkhp->bnthp", C_,
                           prev_states.to(C_.dtype))
    y = y_local + y_carry * carry_decay[..., None]
    return y.reshape(Bb, S, H, P)


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    H, P = _heads_for(d_inner)
    return d_inner, H, P, cfg.ssm.state_dim


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence SSM block. x: [B, S, d_model] -> [B, S, d_model]."""
    d_inner, H, P, N = _dims(cfg)
    xz = linear(x, p.w_in.to(x.dtype))
    u, z = xz.chunk(2, dim=-1)
    u = silu(_causal_conv(u, p.conv_w.to(x.dtype)))
    bc = linear(u, p.w_bc.to(x.dtype))
    B = bc[..., :N].float()
    C = bc[..., N:].float()
    dt = F.softplus((linear(u, p.w_dt.to(x.dtype))).float()
                    + p.dt_bias[None, None])                   # [B,S,H]
    a = -torch.exp(p.a_log)                                    # [H] < 0
    uh = reshape(u, *u.shape[:-1], H, P).float()
    if is_dtensor(uh):
        # per head: each rank scans its own heads (B and C are shared)
        rows = ("dp", None, None)
        y = on_local(lambda *t: ssd_scan(*t, cfg.ssm.chunk),
                     (uh, dt, a, B, C),
                     (HEAD_DIMS, HEAD_DIMS[:3], ("model",), rows, rows),
                     HEAD_DIMS, uh.shape)
    else:
        y = ssd_scan(uh, dt, a, B, C, cfg.ssm.chunk)
    y = reshape(y, *x.shape[:-1], d_inner).to(x.dtype)
    y = y + u * p.d_skip.to(x.dtype)[None, None]
    y = y * silu(z)
    return linear(y, p.w_out.to(x.dtype))


# ----------------------------------------------------------------- decode step
def init_ssm_cache(cfg: ArchConfig, batch: int, layers: int, *,
                   device="cuda"):
    """f32 ``state`` [L, B, N, H, P] and the bf16 conv windows ``conv``
    [L, B, K-1, d_inner]."""
    device = resolve_device(device)
    d_inner, H, P, N = _dims(cfg)
    return {
        "state": torch.zeros(layers, batch, N, H, P, dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(layers, batch, cfg.ssm.conv_kernel - 1, d_inner,
                            dtype=torch.bfloat16, device=device),
    }


def ssm_decode_step(p: SSM, x: torch.Tensor, cfg: ArchConfig,
                    state: torch.Tensor, conv_buf: torch.Tensor):
    """One-token step.  x: [B,1,d_model]; state: [B,N,H,P] f32; conv_buf:
    [B,K-1,d_inner] bf16, both updated in place.  Returns (y [B,1,d],
    state, conv_buf)."""
    d_inner, H, P, N = _dims(cfg)
    xz = linear(x, p.w_in.to(x.dtype))
    u, z = xz.chunk(2, dim=-1)                                 # [B,1,d_inner]
    window = torch.cat([conv_buf.to(u.dtype), u], dim=1)
    u_c = silu(torch.einsum("bkd,kd->bd", window,
                            p.conv_w.to(u.dtype)))[:, None, :]
    conv_buf.copy_(window[:, 1:, :])                           # rounds to bf16
    bc = linear(u_c, p.w_bc.to(x.dtype))
    B = bc[:, 0, :N].float()                                   # [B,N]
    C = bc[:, 0, N:].float()
    dt = F.softplus((linear(u_c, p.w_dt.to(x.dtype))).float()
                    + p.dt_bias[None, None])[:, 0]             # [B,H]
    a = -torch.exp(p.a_log)
    dec = torch.exp(dt * a[None])                              # [B,H]
    uh = reshape(u_c[:, 0], -1, H, P).float()                   # [B,H,P]
    du = dt[..., None] * uh
    state.mul_(dec[:, None, :, None]).add_(
        B[:, :, None, None] * du[:, None])
    y = torch.einsum("bk,bkhp->bhp", C, state)                 # [B,H,P]
    y = reshape(y, -1, 1, d_inner).to(x.dtype)
    y = y + u_c * p.d_skip.to(x.dtype)[None, None]
    y = y * silu(z)
    return linear(y, p.w_out.to(x.dtype)), state, conv_buf
