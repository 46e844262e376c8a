"""PyTorch port, the vlm family (internvl2-1b) and the frontend stubs
(``models/frontends.py``) on the CPU, against the reference.

internvl2-1b at ``.smoke()``: 2 layers, d_model 128, 4/2 heads, 8
frontend tokens, float32.  The reference's weights cross over with
``params_from_jax``.  The port cannot reproduce ``jax.random``'s bits, so
one numpy frontend (``numpy.random.default_rng``) goes to both packages.

Tolerances: logits and the loss at 1e-5 (the same f32 arithmetic summed
in another order); the train step in f32 at 1e-5 on loss and grad norm
(as ``tests/test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import frontends as ref_frontends
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import api, frontends, lm
from repro_torch.models.convert import adamw_from_jax, params_from_jax
from repro_torch.train import step as tstep

TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = ref_arch("internvl2-1b").smoke(), \
        get_arch("internvl2-1b").smoke()
    rp = ref_api.init_params(jax.random.PRNGKey(12), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _inputs(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
          * 0.02).astype(np.float32)
    return toks, np.roll(toks, -1, 1), fe


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_frontend_shape_is_the_references(name):
    for smoke in (False, True):
        r, t = ref_arch(name), get_arch(name)
        if smoke:
            r, t = r.smoke(), t.smoke()
        assert frontends.frontend_shape(t, 3) == \
            ref_frontends.frontend_shape(r, 3)


def test_synthetic_frontend_draws_the_references_distribution():
    """Shape, dtype and scale of the reference's (normal times 0.02, f32);
    seeded and repeatable; ``None`` without a frontend.  The values are
    not the reference's (another generator)."""
    cfg = get_arch("internvl2-1b")
    a = frontends.synthetic_frontend(cfg, 4, seed=3, device="cpu")
    b = frontends.synthetic_frontend(cfg, 4, seed=3, device="cpu")
    c = frontends.synthetic_frontend(cfg, 4, seed=4, device="cpu")
    ref = np.asarray(ref_frontends.synthetic_frontend(
        ref_arch("internvl2-1b"), 4, seed=3))
    assert tuple(a.shape) == ref.shape == (4, 256, 896)
    assert a.dtype == torch.float32 and str(ref.dtype) == "float32"
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) - 0.02) < 1e-3
    assert abs(float(ref.std()) - 0.02) < 1e-3
    assert frontends.synthetic_frontend(get_arch("smollm-135m"), 4,
                                        device="cpu") is None


def test_forward_prepends_the_frontend(model):
    rcfg, rp, tcfg, tp = model
    toks, _, fe = _inputs(rcfg)
    want = np.asarray(ref_api.forward(rp, jnp.asarray(toks), rcfg,
                                      jnp.asarray(fe)))
    got = api.forward(tp, torch.from_numpy(toks), tcfg, torch.from_numpy(fe))
    assert tuple(got.shape) == want.shape == (2, 8 + 16, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the text positions see the patches: without them the logits differ
    text_only = api.forward(tp, torch.from_numpy(toks), tcfg)
    assert tuple(text_only.shape) == (2, 16, tcfg.vocab_size)
    assert not torch.allclose(text_only, got[:, 8:])


def test_hidden_forward_casts_the_frontend_to_the_compute_dtype(model):
    _, _, tcfg, tp = model
    toks, _, fe = _inputs(tcfg, B=1, S=4)
    cfg = tcfg.replace(dtype="bfloat16")
    with torch.no_grad():
        h = lm.hidden_forward(tp, torch.from_numpy(toks), cfg,
                              torch.from_numpy(fe))
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (1, 12, 128)


def test_dense_family_ignores_the_frontend():
    cfg = get_arch("smollm-135m").smoke()
    tp = api.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    fe = torch.randn(2, 8, cfg.d_model)
    assert torch.equal(api.forward(tp, toks, cfg, fe),
                       api.forward(tp, toks, cfg))


def test_loss_is_on_the_text_only(model):
    rcfg, rp, tcfg, tp = model
    toks, tg, fe = _inputs(rcfg, seed=1)
    want = float(ref_api.loss_fn(rp, jnp.asarray(toks), jnp.asarray(tg),
                                 rcfg, jnp.asarray(fe)))
    got = api.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tg), tcfg,
                      torch.from_numpy(fe))
    np.testing.assert_allclose(got.item(), want, rtol=TOL)
    # the CE of the forward's logits at the text positions
    logits = api.forward(tp, torch.from_numpy(toks), tcfg,
                         torch.from_numpy(fe))[:, fe.shape[1]:]
    np.testing.assert_allclose(
        got.item(), lm.cross_entropy(logits, torch.from_numpy(tg)).item(),
        rtol=TOL)


def test_chunked_head_loss_with_a_frontend(model):
    """1024 text tokens after 8 patches: the loss drops the patches before
    the chunked head + CE (S 1024 is a multiple of 512 above it, the
    1032 positions of the whole stream are not)."""
    rcfg, rp, tcfg, tp = model
    toks, tg, fe = _inputs(rcfg, B=1, S=1024, seed=2)
    want = float(ref_lm.loss_fn(rp, jnp.asarray(toks), jnp.asarray(tg), rcfg,
                                jnp.asarray(fe)))
    got = api.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tg), tcfg,
                      torch.from_numpy(fe))
    np.testing.assert_allclose(got.item(), want, rtol=TOL)


def test_train_step_takes_a_numpy_frontend(model):
    """``make_train_step`` in f32 with ``batch["frontend"]`` as numpy (as
    ``data.pipeline`` makes it): two steps from a state past the warm-up,
    loss and grad norm as the reference's."""
    rcfg, rp, tcfg, _ = model
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    rs = ref_adamw.init_adamw(rp)._replace(step=jnp.asarray(150, jnp.int32))
    ts = adamw_from_jax(jax.tree.map(np.asarray, rs), tcfg, device="cpu")
    r_step = jax.jit(ref_step.make_train_step(rcfg, cast_bf16=False))
    t_step = tstep.make_train_step(tcfg, cast_bf16=False)
    for i in range(2):
        toks, tg, fe = _inputs(rcfg, seed=10 + i)
        rp, rs, rm = r_step(rp, rs, {"tokens": jnp.asarray(toks),
                                     "targets": jnp.asarray(tg),
                                     "frontend": jnp.asarray(fe)})
        tp, ts, tm = t_step(tp, ts, {"tokens": torch.from_numpy(toks),
                                     "targets": torch.from_numpy(tg),
                                     "frontend": fe})
        np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=TOL)
