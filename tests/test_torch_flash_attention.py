"""PyTorch port, flash attention on the CPU: the plain version and the
model-facing dispatcher against the reference's Pallas kernel (interpret
mode) and its ``attention_ref``.

Inputs come from ``numpy.random.default_rng`` and go to both packages.
Tolerances: float32 at 1e-5 (the port and the reference sum in another
order; the errors seen are ~1e-6); bfloat16 at the reference's own 2e-2
(both round the f32 result to bf16, and a value near a rounding midpoint
can round either way).  The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


def _bhsd(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),
    (1, 256, 8, 2, 128),
    (2, 128, 3, 1, 64),        # odd head count (GQA 3:1)
])
def test_flash_attention_matches_reference(B, S, H, Hkv, hd, dtype):
    """The cases of the reference's test_flash_attention_matches_ref."""
    q, k, v = _inputs(S + H, B, S, H, Hkv, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = _np(ref_flash(*(_jax(x, jdt) for x in (q, k, v)),
                         interpret=True))
    got = tops.flash_attention(*(_torch(x, tdt) for x in (q, k, v)))
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    G = H // Hkv
    want_ref = _np(ref_attention(*(_jax(_bhsd(x), jdt) for x in (q, k, v)),
                                 group_size=G))
    got_ref = tref.attention_ref(*(_torch(_bhsd(x), tdt) for x in (q, k, v)),
                                 group_size=G)
    np.testing.assert_allclose(_np(got_ref), want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [0, 64, 200])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_flash_attention_window_softcap(window, softcap):
    """The cases of the reference's test_flash_attention_window_softcap."""
    B, S, H, Hkv, hd = 1, 256, 2, 1, 64
    q, k, v = _inputs(7, B, S, H, Hkv, hd)
    want = _np(ref_flash(*(jnp.asarray(x) for x in (q, k, v)), window=window,
                         softcap=softcap, interpret=True))
    got = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               window=window, softcap=softcap)
    np.testing.assert_allclose(_np(got), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("S,hd,window,causal", [
    (100, 32, 0, True),       # ragged S (the Pallas kernel needs S <= 128)
    (37, 64, 5, True),
    (300, 32, 64, True),
    (64, 32, 0, False),
    (64, 32, 16, False),
])
def test_plain_version_matches_attention_ref_on_any_shape(S, hd, window,
                                                          causal):
    """The port's kernel takes any S; its plain version agrees with the
    reference's oracle there too, causal or not."""
    B, H, Hkv = 2, 4, 2
    q, k, v = (_bhsd(x) for x in _inputs(S, B, S, H, Hkv, hd))
    want = np.asarray(ref_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=causal, window=window,
                                    softcap=30.0, group_size=2))
    got = tkernel.flash_attention_bhsd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, softcap=30.0, group_size=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_window_of_one_keeps_only_the_diagonal():
    """Causal with window 1: each query row keeps its own key only, so the
    output is v; the online softmax's first tiles are fully masked for
    every row but the diagonal's."""
    S, hd = 16, 32
    q, k, v = (torch.from_numpy(_bhsd(x)) for x in _inputs(3, 1, S, 1, 1, hd))
    out = tkernel.flash_attention_bhsd(q, k, v, causal=True, window=1)
    np.testing.assert_allclose(out.numpy(), v.numpy(), rtol=1e-6, atol=1e-6)


def _tensor_core_numerics(q, k, v, *, causal, window, softcap, group_size):
    """Plain emulation of the bf16 tensor-core kernel's arithmetic
    (``flash_tc_kernel`` in ``csrc/flash_attention.cu``): 64-row query
    tiles over the kept key tiles (64 keys, 32 at hd 256), scores from
    the bf16 operands in f32, the online softmax in base
    2, P rounded to bf16 (a bf16 high part plus a bf16 low part on the
    tiles that cross a mask bound and on every tile of a query tile whose
    rows keep fewer than 256 keys), the denominator summed from P in f32,
    and the f32 accumulator rounded to bf16 once at the end."""
    BH, S, hd = q.shape
    BQ, BK = 64, (64 if hd <= 128 else 32)
    log2e = 1.0 / math.log(2.0)
    qf = q.float()
    kf = k.float().repeat_interleave(group_size, dim=0)
    vf = v.float().repeat_interleave(group_size, dim=0)
    out = torch.zeros(BH, S, hd)
    for q0 in range(0, S, BQ):
        rows = torch.arange(q0, min(q0 + BQ, S))
        k_hi = int(rows[-1]) + 1 if causal else S
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        min_keys = q0 + 1 if causal else S
        if window > 0:
            min_keys = min(min_keys, window)
        m = torch.full((BH, len(rows)), -math.inf)
        l = torch.zeros(BH, len(rows))
        acc = torch.zeros(BH, len(rows), hd)
        for t in range(k_lo // BK, (k_hi + BK - 1) // BK):
            kb = t * BK
            keys = torch.arange(kb, min(kb + BK, S))
            s = qf[:, rows] @ kf[:, keys].transpose(1, 2)
            if softcap > 0:
                s = softcap * torch.tanh(s / math.sqrt(hd) / softcap) * log2e
            else:
                s = s * (log2e / math.sqrt(hd))
            masked = (kb + BK > S or (causal and kb + BK - 1 > q0)
                      or (window > 0 and kb <= q0 + BQ - 1 - window))
            if masked:
                keep = torch.ones(len(rows), len(keys), dtype=torch.bool)
                if causal:
                    keep &= keys[None, :] <= rows[:, None]
                if window > 0:
                    keep &= keys[None, :] > rows[:, None] - window
                s = s.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            parts = [p.bfloat16().float()]
            if masked or min_keys < 256:
                parts.append((p - parts[0]).bfloat16().float())
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc
            for part in parts:
                acc = acc + part @ vf[:, keys]
            m = m_new
        out[:, rows] = torch.where(l[..., None] > 0,
                                   acc / l.clamp_min(1e-30)[..., None], 0.0)
    return out.bfloat16()


@pytest.mark.parametrize("S,hd,H,Hkv,window,softcap,causal", [
    (300, 64, 6, 2, 0, 0.0, True),       # causal, GQA 3:1, ragged S
    (200, 32, 4, 1, 0, 0.0, True),
    (130, 256, 4, 1, 0, 0.0, True),      # 32-key tiles
    (333, 64, 4, 1, 100, 50.0, True),    # window and softcap
    (257, 256, 2, 2, 64, 30.0, True),
    (150, 64, 2, 1, 0, 30.0, False),     # not causal
    (129, 64, 3, 1, 1, 0.0, True),       # one kept key a row
    (129, 32, 4, 2, 2, 0.0, True),       # two kept keys a row
    (2, 64, 2, 1, 0, 0.0, True),         # rows of one and two keys
    (640, 64, 12, 3, 0, 0.0, True),      # rows past 256 keys: P rounded once
])
def test_tensor_core_numerics_stay_inside_the_bf16_tolerance(
        S, hd, H, Hkv, window, softcap, causal):
    """The tensor-core route rounds P to bf16 before P.V, which the exact
    plain version does not; emulated on seeded N(0, 1) inputs, its output
    stays inside the bound that ``chip_smoke.py`` phase 8 holds the bf16
    kernel to: rtol 2^-7 (one bf16 step of the output) and atol 1e-3."""
    q, k, v = (torch.from_numpy(_bhsd(x)).bfloat16()
               for x in _inputs(S + hd, 1, S, H, Hkv, hd))
    kw = dict(causal=causal, window=window, softcap=softcap,
              group_size=H // Hkv)
    got = _tensor_core_numerics(q, k, v, **kw)
    want = tref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def test_flash_attention_matches_model_sdpa():
    """The dispatcher against the port's decode-side ``_sdpa`` (the
    reference's test_flash_attention_matches_model_sdpa)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.attention import _sdpa
    from repro_torch.models.common import causal_mask
    cfg = get_arch("smollm-135m").smoke()
    B, S, hd = 1, 128, cfg.resolved_head_dim
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(3, B, S, cfg.num_heads, cfg.num_kv_heads, hd))
    pos = torch.arange(S)[None]
    sdpa = _sdpa(q, k, v, causal_mask(pos, pos), cfg)
    flash = tops.flash_attention(q, k, v)
    np.testing.assert_allclose(sdpa.numpy(), flash.reshape(B, S, -1).numpy(),
                               rtol=3e-5, atol=3e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 1, 32, 2, 1, 32))
    before = _cuda.FLASH.launches
    out = tops.flash_attention(q, k, v)
    assert _cuda.FLASH.launches == before
    want = tref.attention_ref(*(x.transpose(1, 2).reshape(-1, 32, 32)
                                for x in (q, k, v)), group_size=2)
    assert torch.equal(out.transpose(1, 2).reshape(-1, 32, 32), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4, 16, 32)
    kv = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="dtype|is torch"):
        tkernel.flash_attention_bhsd(q, kv.double(), kv, group_size=2)
    with pytest.raises(ValueError, match="must be"):
        tkernel.flash_attention_bhsd(q, kv, kv, group_size=3)
    with pytest.raises(ValueError, match="must be"):
        tkernel.flash_attention_bhsd(q, kv[:, :8], kv[:, :8], group_size=2)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        m = torch.empty(4, 16, 32, device="meta")
        tkernel.flash_attention_bhsd(m, m[:2], m[:2], group_size=2)
    with pytest.raises(ValueError, match="must be"):   # 3 heads over 2
        tops.flash_attention(torch.zeros(1, 16, 3, 32),
                             torch.zeros(1, 16, 2, 32),
                             torch.zeros(1, 16, 2, 32))


@pytest.mark.parametrize("B", [1, 2])
def test_dispatcher_hands_the_kernel_dense_rows(monkeypatch, B):
    """The kernel takes contiguous [BH, S, hd] rows.  At B = 1 the
    dispatcher's head-major reshapes are views with the transposes'
    strides, which the CUDA wrapper rejects; the dispatcher must hand it
    dense copies (a B = 1 prefill on the card raised before)."""
    seen = []

    def wrapper(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return tref.attention_ref(q, k, v, **kw)

    monkeypatch.setattr(tops, "flash_attention_bhsd", wrapper)
    rng = np.random.default_rng(B)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 8, h, 32))
                                .astype(np.float32)) for h in (4, 2, 2))
    out = tops.flash_attention(q, k, v)
    assert seen == [True] and out.shape == (B, 8, 4, 32)
    want = np.asarray(ref_flash(jnp.asarray(q.numpy()), jnp.asarray(
        k.numpy()), jnp.asarray(v.numpy())))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
