"""PyTorch port, the encoder-decoder (``models/encdec.py``,
seamless-m4t-medium, ``family="audio"``) on the CPU, against the
reference.

seamless-m4t-medium at ``.smoke()``: 2 encoder and 2 decoder layers,
d_model 128, 4/4 heads, 8 frames, float32.  The reference's weights cross
over with ``params_from_jax``; tokens and the frames come from
``numpy.random.default_rng`` and go to both packages.

Tolerances, each with its reason:

- ``encode``, ``_cross_attention``, logits and the loss at 1e-5: the
  same f32 arithmetic summed in another order;
- decode with ``enc`` filled against the forward at 2e-2 (the
  reference's own bound for decode against forward, dense): decode reads
  the encoder states and its K/V from bf16 caches (seen: 1.4e-3 on
  logits of magnitude ~0.9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_arch
from repro_torch.models import api, encdec
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine

TOL = 1e-5
CONSISTENCY_TOL = 2e-2


@pytest.fixture(scope="module")
def model():
    rcfg = ref_arch("seamless-m4t-medium").smoke()
    tcfg = get_arch("seamless-m4t-medium").smoke()
    rp = ref_api.init_params(jax.random.PRNGKey(13), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _frames(cfg, B=2, seed=0, F=None):
    return (np.random.default_rng(seed).standard_normal(
        (B, F or cfg.frontend_tokens, cfg.d_model)) * 0.02
            + 0.5 * np.random.default_rng(seed + 1).standard_normal(
                (B, F or cfg.frontend_tokens, cfg.d_model))).astype(
        np.float32)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_params_round_trip_and_the_module_surface(model):
    """``EncDec`` has what the engines, optimizer and converter read: a
    ``device``, seeded ``reset_parameters``, and ``named_parameters``
    that stack back into the reference's tree."""
    rcfg, rp, tcfg, tp = model
    assert tp.device.type == "cpu"
    back = params_to_numpy(tp, tcfg)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, rp))
    got = jax.tree_util.tree_flatten_with_path(back)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (_, a), (_, b) in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    a = api.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    b = api.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    assert isinstance(a, encdec.EncDec)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not a.enc_norm.detach().any()
    assert not a.dec_layers[0].lnx.detach().any()


def test_encode_matches_the_reference(model):
    rcfg, rp, tcfg, tp = model
    fr = _frames(rcfg)
    want = ref_encdec.encode(rp, jnp.asarray(fr), rcfg)
    with torch.no_grad():
        got = encdec.encode(tp, torch.from_numpy(fr), tcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("Sq", [1, 8, 1024])
def test_cross_attention_matches_the_reference(model, Sq):
    """One query (decode), a few, and 1024: two blocks of 512 queries."""
    rcfg, rp, tcfg, tp = model
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((2, Sq, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, rcfg.d_model)).astype(np.float32)
    r_x = jax.tree.map(lambda a: a[0], rp["dec_layers"]["xattn"])
    want = ref_encdec._cross_attention(r_x, jnp.asarray(x), jnp.asarray(enc),
                                       rcfg)
    with torch.no_grad():
        got = encdec._cross_attention(tp.dec_layers[0].xattn,
                                      torch.from_numpy(x),
                                      torch.from_numpy(enc), tcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("S", [16, 1024])
def test_forward_matches_the_reference(model, S):
    rcfg, rp, tcfg, tp = model
    toks, fr = _tokens(rcfg, (1, S), seed=S), _frames(rcfg, B=1, seed=S)
    want = ref_api.forward(rp, jnp.asarray(toks), rcfg, jnp.asarray(fr))
    got = api.forward(tp, torch.from_numpy(toks), tcfg, torch.from_numpy(fr))
    assert tuple(got.shape) == (1, S, tcfg.vocab_size)
    _close(got.numpy(), want)


def test_loss_matches_the_reference_on_the_chunked_lanes(model):
    """S 1024: the train lane's chunked self-attention and the
    cross-attention's two query blocks, each checkpointed."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (1, 1024), seed=3)
    tg, fr = np.roll(toks, -1, 1), _frames(rcfg, B=1, seed=3)
    want = ref_api.loss_fn(rp, jnp.asarray(toks), jnp.asarray(tg), rcfg,
                           jnp.asarray(fr))
    got = api.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tg), tcfg,
                      torch.from_numpy(fr))
    assert got.requires_grad
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)


def test_decode_with_the_encoder_states_matches_forward(model):
    """The meaningful decode: ``cache["enc"] = encode(frames)`` (bf16, as
    the cache keeps it), then the prompt token by token against the
    teacher-forced forward on the same frames."""
    _, _, tcfg, tp = model
    toks = torch.from_numpy(_tokens(tcfg, (2, 12), seed=4))
    fr = torch.from_numpy(_frames(tcfg, seed=4))
    full = api.forward(tp, toks, tcfg, fr)
    cache = api.init_cache(tcfg, 2, 16, device="cpu")
    assert cache["enc"].dtype == torch.bfloat16
    with torch.no_grad():
        cache["enc"].copy_(encdec.encode(tp, fr, tcfg))
    step = []
    for t in range(toks.shape[1]):
        lg, cache = api.decode_step(tp, toks[:, t:t + 1], cache, tcfg)
        step.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(step, 1).numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    # and the zeroed encoder states give other logits
    zero = api.init_cache(tcfg, 2, 16, device="cpu")
    lg0, _ = api.decode_step(tp, toks[:, :1], zero, tcfg)
    assert not torch.allclose(lg0[:, 0], step[0], atol=1e-3)


def test_engines_serve_against_zero_encoder_states(model):
    """The reference's fault, kept as the spec (ROADMAP queue 1 item 10):
    ``init_cache`` zeroes ``enc`` and neither engine writes it, so the
    engines decode against zero encoder states: ``generate`` equals a
    decode loop on a fresh cache, and ``enc`` stays zero."""
    _, _, tcfg, tp = model
    prompts = _tokens(tcfg, (2, 5), seed=5)
    got = ServeEngine(tcfg, tp, 2, 16).generate(prompts, 4)
    cache = api.init_cache(tcfg, 2, 16, device="cpu")
    for t in range(5):
        lg, cache = api.decode_step(tp, torch.from_numpy(prompts[:, t:t + 1]),
                                    cache, tcfg)
    want = []
    for _ in range(4):
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        want.append(tok.numpy())
        lg, cache = api.decode_step(tp, tok, cache, tcfg)
    np.testing.assert_array_equal(got, np.concatenate(want, 1))
    cb = ContinuousBatchingEngine(tcfg, tp, 2, 16)
    cb.run([prompts[0], prompts[1]], 3)
    assert float(cb.cache["enc"].float().abs().sum()) == 0
