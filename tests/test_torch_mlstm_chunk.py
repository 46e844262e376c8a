"""PyTorch port, the chunked mLSTM on the CPU: the plain version and the
model-facing dispatcher against the reference's Pallas kernel (interpret
mode), its ``mlstm_ref`` and its model scan ``_ssd_scan_perhead``.

Inputs come from ``numpy.random.default_rng`` and go to both packages, in
float32 (the model's dtype on this path).  Tolerance: the reference's own
2e-4 (``tests/test_kernels.py::test_mlstm_chunk_*``): the chunked and the
direct forms sum the same terms in another order, and the readout grows to
|y| ~ 5 over 256 steps; the errors seen are ~1e-5.  The CUDA kernel itself
runs only on the card (``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ops import mlstm_chunk as ref_mlstm_chunk
from repro.kernels.mlstm_chunk.ref import mlstm_ref as ref_mlstm_ref
from repro.models.xlstm import _ssd_scan_perhead as ref_scan
from repro_torch.kernels import _cuda
from repro_torch.kernels.mlstm_chunk import kernel as tkernel
from repro_torch.kernels.mlstm_chunk import ops as tops
from repro_torch.kernels.mlstm_chunk import ref as tref
from repro_torch.models import xlstm as txlstm

TOL = 2e-4


def _inputs(seed, B, S, H, P, Pv):
    """q, k [B,S,H,P]; v [B,S,H,Pv]; ig (a sigmoid) and la (a log-sigmoid,
    <= 0) [B,S,H], as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, Pv)).astype(np.float32)
    ig = (1 / (1 + np.exp(-rng.standard_normal((B, S, H))))).astype(
        np.float32)
    la = (-np.logaddexp(0, -(rng.standard_normal((B, S, H)) + 1.0))).astype(
        np.float32)
    return q, k, v, ig, la


def _bh(x):
    """[B, S, H, ...] -> [B*H, S, ...]."""
    x = np.moveaxis(x, 2, 1)
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("S,chunk", [(128, 32), (128, 128), (256, 64)])
@pytest.mark.parametrize("P,Pv", [(32, 32), (64, 65)])
def test_mlstm_chunk_matches_reference(S, chunk, P, Pv):
    """The cases of the reference's test_mlstm_chunk_matches_ref: the
    port's dispatcher against the reference's Pallas kernel and its
    ``mlstm_ref``."""
    B, H = 2, 3
    xs = _inputs(S + P, B, S, H, P, Pv)
    got = tops.mlstm_chunk(*_t(xs), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H, Pv)
    want = np.asarray(ref_mlstm_chunk(*map(jnp.asarray, xs), chunk=chunk,
                                      interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want_ref = np.asarray(ref_mlstm_ref(*map(jnp.asarray,
                                             map(_bh, xs))))
    got_bh = got.transpose(1, 2).reshape(B * H, S, Pv).numpy()
    np.testing.assert_allclose(got_bh, want_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 7, 64])
def test_plain_version_matches_the_references(S):
    """``ref.mlstm_ref`` (mask before the exp) against the reference's
    (mask after): the same values."""
    xs = [_bh(x) for x in _inputs(S, 1, S, 2, 16, 17)]
    got = tref.mlstm_ref(*_t(xs)).numpy()
    want = np.asarray(ref_mlstm_ref(*map(jnp.asarray, xs)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_version_masks_before_the_exp():
    """A strongly decaying gate: for s > t the reference's exp(cum[t] -
    cum[s]) is exp(+large) = inf before its mask; the port never forms it
    and stays finite where the unmasked product would not be."""
    xs = list(_inputs(5, 1, 64, 1, 8, 9))
    xs[4] = np.full_like(xs[4], -40.0)      # cum[63] - cum[0] = -2520
    out = tref.mlstm_ref(*_t([_bh(x) for x in xs]))
    assert torch.isfinite(out).all()
    cum = torch.cumsum(torch.from_numpy(_bh(xs[4])), 1)
    assert torch.isinf(torch.exp(cum[:, None, :] - cum[:, :, None])).any()


def test_mlstm_chunk_matches_model_scan():
    """The reference's test_mlstm_chunk_matches_model_scan: the port's
    dispatcher and the port's ``_ssd_scan_perhead`` against the
    reference's scan."""
    B, S, H, P = 1, 128, 2, 32
    xs = _inputs(11, B, S, H, P, P + 1)
    want = np.asarray(ref_scan(*map(jnp.asarray, xs), chunk=32))
    got = tops.mlstm_chunk(*_t(xs), chunk=32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got_scan = txlstm._ssd_scan_perhead(*_t(xs), chunk=32).numpy()
    np.testing.assert_allclose(got_scan, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,chunk", [(12, 16), (16, 16), (5, 256)])
def test_sequence_within_one_chunk(S, chunk):
    """S <= chunk: one chunk of S rows (``chunk = min(chunk, S)``)."""
    xs = _inputs(S + chunk, 2, S, 4, 64, 65)
    got = tops.mlstm_chunk(*_t(xs), chunk=chunk).numpy()
    want = np.asarray(ref_mlstm_chunk(*map(jnp.asarray, xs), chunk=chunk,
                                      interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ragged_sequence_raises():
    """S not a multiple of the chunk: the reference asserts, the port
    raises (on the CPU too, before any work)."""
    xs = _t(_inputs(0, 1, 40, 2, 16, 17))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.mlstm_chunk(*xs, chunk=16)
    with pytest.raises(AssertionError):
        ref_mlstm_chunk(*(jnp.asarray(x.numpy()) for x in xs), chunk=16,
                        interpret=True)
    with pytest.raises(ValueError, match="multiple of chunk"):
        txlstm._ssd_scan_perhead(*xs, chunk=16)


def test_wrapper_checks_shapes_and_runs_no_kernel_on_the_cpu():
    q, k, v, ig, la = _t([_bh(x) for x in _inputs(1, 1, 32, 2, 16, 17)])
    with pytest.raises(ValueError, match=r"\[BH, S, P\]"):
        tkernel.mlstm_chunk_bhsd(q, k[:, :16], v, ig, la, chunk=16)
    with pytest.raises(ValueError, match=r"\[BH, S, P\]"):
        tkernel.mlstm_chunk_bhsd(q, k, v, ig[:1], la, chunk=16)
    before = _cuda.MLSTM.launches
    out = tkernel.mlstm_chunk_bhsd(q, k, v, ig, la, chunk=16)
    assert _cuda.MLSTM.launches == before
    assert tuple(out.shape) == (2, 32, 17)


@pytest.mark.parametrize("where", ["mixed", "meta"])
def test_wrapper_raises_off_the_cpu_without_the_card(where):
    """Only a CPU tensor takes the plain version: tensors on two devices,
    or on a device with no kernel, raise before any work."""
    xs = _t([_bh(x) for x in _inputs(2, 1, 32, 2, 16, 17)])
    if where == "mixed":
        xs[2] = xs[2].to("meta")
        match = "v is on meta"
    else:
        xs = [x.to("meta") for x in xs]
        match = "no mLSTM kernel for device meta"
    before = _cuda.MLSTM.launches
    with pytest.raises(ValueError, match=match):
        tkernel.mlstm_chunk_bhsd(*xs, chunk=16)
    assert _cuda.MLSTM.launches == before


# -------------------------------------------- the kernel's arithmetic, emulated
def _split(x):
    """x as a bf16 high part and a bf16 low part, each as f32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm3(a, b, acc=None, products=3):
    """acc + a @ b as the kernel's tensor cores take it: a and b split into
    bf16 parts, the products al.bh + ah.bl + ah.bh (al.bl dropped) one
    16-deep k-step at a time (the mma's depth), summed in f32.
    ``products=1`` keeps ah.bh alone (one bf16 product)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    pairs = ((al, bh), (ah, bl), (ah, bh))[3 - products:]
    for k0 in range(0, a.shape[-1], 16):
        ks = slice(k0, k0 + 16)
        for x, y in pairs:
            acc = acc + x[..., ks] @ y[..., ks, :]
    return acc


def _tensor_core_numerics(q, k, v, ig, la, chunk, products=3):
    """A plain emulation of ``csrc/mlstm_chunk.cu``'s arithmetic, in its
    order: the in-chunk cumsum in f32; q~ = q exp(cum) and
    kd = k exp(cum[c-1] - cum) ig, formed in f32 and split; the scores from
    split q and k, masked before the exp, then split; per chunk one f32
    accumulator for y over the score steps and then the carry steps
    (v^T sc^T + state^T q~^T, skipped in chunk 0), and the f32 state
    updated as decay * state + v^T kd (skipped after the last chunk), split
    again for every chunk's carry product and never kept in 16 bits.
    Shapes as ``mlstm_chunk_bhsd``'s: [BH, S, ·]; ``products`` as
    :func:`_mm3`'s."""
    BH, S, P = q.shape
    Pv = v.shape[-1]
    c, nC = chunk, S // chunk
    cum = torch.cumsum(la.reshape(BH, nC, c), dim=2)
    q_, k_ = q.reshape(BH, nC, c, P), k.reshape(BH, nC, c, P)
    v_ = v.reshape(BH, nC, c, Pv)
    qt = q_ * torch.exp(cum)[..., None]
    kd = k_ * (torch.exp(cum[..., -1:] - cum) * ig.reshape(BH, nC, c))[..., None]
    causal = torch.ones(c, c, dtype=torch.bool).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, 0.0)
    sc = torch.where(causal, _mm3(q_, k_.transpose(-1, -2), None, products)
                     * torch.exp(diff)
                     * ig.reshape(BH, nC, 1, c), torch.zeros(()))
    state = torch.zeros(BH, P, Pv)
    ys = []
    for n in range(nC):
        y = _mm3(sc[:, n], v_[:, n], None, products)
        if n > 0:
            y = _mm3(qt[:, n], state, y, products)
        ys.append(y)
        if n < nC - 1:
            state = (torch.exp(cum[:, n, -1])[:, None, None] * state
                     + _mm3(kd[:, n].transpose(1, 2), v_[:, n], None,
                            products))
    return torch.stack(ys, 1).reshape(BH, S, Pv)


def _numerics_inputs(kind, BH, S, P, Pv):
    """Seeded f32 inputs as phase 12 draws them; ``bf16_exact``: q, k, v
    bf16 values widened (q then scaled by 1/32, exactly, as the model
    scales it at P 1024); ``slow_decay``: la ~ -1e-3."""
    rng = np.random.default_rng(S + P + Pv)
    q = rng.standard_normal((BH, S, P)) / np.sqrt(P)
    k = rng.standard_normal((BH, S, P))
    v = rng.standard_normal((BH, S, Pv))
    ig = 1 / (1 + np.exp(-rng.standard_normal((BH, S))))
    la = -np.logaddexp(0, -(rng.standard_normal((BH, S)) + 1.0))
    if kind == "slow_decay":
        la = -1e-3 * rng.random((BH, S))
    xs = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, ig, la)]
    if kind == "bf16_exact":
        xs[0] = xs[0].mul(np.sqrt(P)).bfloat16().float() / 32
        xs[1], xs[2] = (x.bfloat16().float() for x in xs[1:3])
    return xs


@pytest.mark.parametrize("kind,BH,S,P,Pv,chunk", [
    ("f32", 3, 256, 48, 33, 32),          # general f32 inputs, odd Pv
    ("f32", 2, 144, 20, 9, 24),           # P and chunk not multiples of 16
    ("bf16_exact", 3, 256, 64, 65, 64),   # the model's path
    ("slow_decay", 2, 1024, 32, 17, 16),  # 64 chunks, la ~ -1e-3
])
def test_tensor_core_numerics_stay_inside_the_f32_tolerance(
        kind, BH, S, P, Pv, chunk):
    """The kernel's split-bf16 products with an f32 state, emulated on the
    CPU, against the plain version within phase 12's 2e-4 x max |y| (the
    errors seen are 4-5 % of it).  The slow-decay case carries the state
    over 64 chunks with barely any decay, where a state rounded to 16 bits
    between chunks would drift."""
    xs = _numerics_inputs(kind, BH, S, P, Pv)
    got = _tensor_core_numerics(*xs, chunk)
    want = tref.mlstm_ref(*xs)
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2e-4 * scale, (err, scale)
    # and the emulation is the kernel's, not a copy of the plain version:
    # the split products leave an error of their own
    assert err > 0


@pytest.mark.parametrize("kind", ["f32", "slow_decay"])
def test_one_bf16_product_would_miss_the_f32_tolerance(kind):
    """Why the kernel takes three products: the same schedule with one
    bf16 product (ah.bh) misses phase 12's 2e-4 x max |y| many times over
    (its operands keep 8 bits)."""
    xs = _numerics_inputs(kind, 2, 256, 48, 33)
    got = _tensor_core_numerics(*xs, 32, products=1)
    want = tref.mlstm_ref(*xs)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() > 5 * 2e-4 * scale
