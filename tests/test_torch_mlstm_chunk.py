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
