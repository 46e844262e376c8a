"""PyTorch port, the int8 KV cache (``cfg.kv_quant``: minicpm-2b's
config) on the CPU, against the reference's decode step by step.

The reference's weights cross over with ``params_from_jax``, its cache
with ``cache_from_jax`` (int8 K/V and bf16 scales unchanged); tokens come
from ``numpy.random.default_rng``.  The smoke config of minicpm-2b (2
layers, d_model 128, 4/4 heads, hd 32, float32 compute), whose
``kv_quant`` is on.

Tolerances, each with its reason:

- decode logits at ``DECODE_TOL`` 1e-3, as ``tests/test_torch_lm.py``;
- int8 K/V equal, except where the f32 projection, within ~1e-6 of the
  reference's, lands at a rounding tie of ``x / scale``: there the two
  round to neighbouring values.  Such entries are counted and bounded:
  at most ``TIE_FRACTION`` (1e-3) of a step's new entries, one LSB each;
- scales (amax / 127 in f32, stored in bf16) within one bf16 step
  (2^-7 relative): an f32 amax within ~1e-6 of a bf16 rounding midpoint
  rounds either way;
- int8 against a bf16 cache on the same weights: the reference's own
  bound of 0.15 on the logits (``tests/test_moe_ep.py:76``; that test
  sets ``kv_quant`` on both sides, since minicpm's config has it on
  already; here one side has it off);
- the serving engines' tokens identical to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import attention as ref_attention
from repro_torch.configs import get_arch
from repro_torch.models import api, attention
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine

DECODE_TOL = 1e-3
TIE_FRACTION = 1e-3
BF16_STEP = 2.0 ** -7
INT8_VS_BF16 = 0.15


@pytest.fixture(scope="module")
def model():
    rcfg = ref_arch("minicpm-2b").smoke()
    tcfg = get_arch("minicpm-2b").smoke()
    assert rcfg.kv_quant and tcfg.kv_quant
    rp = ref_api.init_params(jax.random.PRNGKey(5), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def test_init_cache_is_the_references_int8_layout(model):
    rcfg, _, tcfg, _ = model
    got = api.init_cache(tcfg, 3, 10, device="cpu")
    want = ref_api.init_cache(rcfg, 3, 10)
    assert got.keys() == want.keys() == {"k", "v", "k_scale", "v_scale",
                                         "pos"}
    dtypes = {"k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16,
              "v_scale": torch.bfloat16, "pos": torch.int32}
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert t.dtype == dtypes[name], name
        assert not bool(t.float().abs().max())
    L, B, T, H, hd = got["k"].shape
    assert (L, B, T, H, hd) == (2, 3, 10, tcfg.num_kv_heads, 32)
    # half the bytes of the bf16 cache it replaces, plus the scales
    bf16 = api.init_cache(tcfg.replace(kv_quant=False), 3, 10, device="cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                           for t in c.values())
    assert nbytes(got) < 0.6 * nbytes(bf16)


def test_quantize_row_is_the_references():
    """Scale in f32, rounding half to even with the f32 scale, then the
    scale stored in bf16; an all-zero row takes the 1e-6 floor."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 4, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    # exact halves of the scale: the rounding rule decides them
    x[1, 0, 0] = np.arange(32, dtype=np.float32) - 15.5
    x[1, 0, 0, -1] = 127.0
    for dt in (np.float32, "bfloat16"):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.from_numpy(x).to(torch.float32 if dt == np.float32
                                    else torch.bfloat16)
        q, s = attention._quantize_row(tx)
        rq, rs = ref_attention._quantize_row(jx)
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.float().numpy(),
                                      np.asarray(rs, np.float32))
    # half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    q, _ = attention._quantize_row(torch.tensor([[0.5, 1.5, -2.5, 127.0]]))
    assert q.tolist() == [[0, 2, -2, 127]]


def _same_int8(got, want, what):
    """int8 arrays equal but for rounding ties: counted and bounded."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"{what}: an entry off by {diff.max()} LSB"
    assert (diff > 0).sum() <= max(1, TIE_FRACTION * diff.size), \
        f"{what}: {(diff > 0).sum()} of {diff.size} entries at ties"
    return int((diff > 0).sum())


def test_decode_step_matches_the_reference_step_by_step(model):
    """Each step starts from the reference's cache, so one step's ties do
    not carry into the next; the port must write the new row as the
    reference does, and read the whole int8 cache as it does."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 7), seed=2)
    rc = ref_api.init_cache(rcfg, 2, 8)
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    ties = 0
    for t in range(toks.shape[1]):
        tc = cache_from_jax(jax.tree.map(np.asarray, rc), device="cpu")
        assert tc["k"].dtype == torch.int8
        assert tc["k_scale"].dtype == torch.bfloat16
        lg_t, tc = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, tcfg)
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        got = cache_to_numpy(tc)
        want = jax.tree.map(np.asarray, rc)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for kv in ("k", "v"):
            assert got[kv].dtype == np.int8
            ties += _same_int8(got[kv], want[kv], f"step {t} {kv}")
            np.testing.assert_allclose(got[kv + "_scale"],
                                       np.asarray(want[kv + "_scale"],
                                                  np.float32),
                                       rtol=BF16_STEP, atol=0)
    assert ties <= 4


def test_decode_carries_its_own_cache_like_the_reference(model):
    """Twelve steps, each side on its own cache (past max_len 8, where the
    insert clamps to the last row): logits within the decode tolerance."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 12), seed=3)
    rc = ref_api.init_cache(rcfg, 2, 8)
    tc = api.init_cache(tcfg, 2, 8, device="cpu")
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        lg_t, tc = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, tcfg)
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    assert tc["pos"].tolist() == [12, 12]


def test_int8_decode_stays_close_to_bf16(model):
    """The reference's test_int8_kv_decode_close_to_bf16 bound, on the
    port, with the bf16 side's kv_quant actually off."""
    _, _, tcfg, tp = model
    cfg16 = tcfg.replace(kv_quant=False)
    toks = torch.from_numpy(_tokens(tcfg, (2, 6), seed=4))
    c = api.init_cache(cfg16, 2, 16, device="cpu")
    cq = api.init_cache(tcfg, 2, 16, device="cpu")
    assert c["k"].dtype == torch.bfloat16 and cq["k"].dtype == torch.int8
    worst = 0.0
    for t in range(6):
        lg, c = api.decode_step(tp, toks[:, t:t + 1], c, cfg16)
        lgq, cq = api.decode_step(tp, toks[:, t:t + 1], cq, tcfg)
        worst = max(worst, (lg - lgq).abs().max().item())
    assert 0 < worst < INT8_VS_BF16


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input (the
    reference's engine aliases ``slot_tokens``; see test_torch_lm.py)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(np.array(a, copy=True), *args, **kw)


@pytest.fixture
def ref_engines(monkeypatch):
    monkeypatch.setattr(ref_engine, "jnp", _CopyingJnp())
    return ref_engine


def test_serve_engine_on_an_int8_cache_matches_the_reference(model,
                                                             ref_engines):
    rcfg, rp, tcfg, tp = model
    prompts = _tokens(rcfg, (3, 5), seed=6)
    want = ref_engines.ServeEngine(rcfg, rp, 3, 32).generate(prompts, 8)
    eng = ServeEngine(tcfg, tp, 3, 32)
    got = eng.generate(prompts, 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    _, cache = eng.prefill(prompts)
    assert cache["k"].dtype == torch.int8


def test_continuous_batching_on_an_int8_cache_matches_the_reference(
        model, ref_engines):
    """Five requests over two slots; admission resets only ``pos`` and
    leaves the int8 rows and scales to the validity mask, as the
    reference's engine does."""
    rcfg, rp, tcfg, tp = model
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, rcfg.vocab_size, (4,)) for _ in range(5)]
    want = ref_engines.ContinuousBatchingEngine(rcfg, rp, 2, 16).run(
        requests, 5)
    eng = ContinuousBatchingEngine(tcfg, tp, 2, 16)
    got = eng.run(requests, 5)
    assert got == want
    assert set(eng.cache) == {"k", "v", "k_scale", "v_scale", "pos"}
    assert eng.cache["v"].dtype == torch.int8
