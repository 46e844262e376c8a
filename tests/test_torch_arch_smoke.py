"""PyTorch port, every architecture on the CPU: the reference's smoke tests
on the port, and the moe, hybrid, vlm and audio families against the
reference.

The first three tests mirror ``tests/test_arch_smoke.py:23-65`` on the
port, over every entry of ``ARCHS`` at ``.smoke()``: one forward (shapes,
finite logits), one loss with finite gradients, two decode steps.

The rest hold granite-moe-3b-a800m and qwen3-moe-30b-a3b (moe),
hymba-1.5b (hybrid, once with its 1024 window, longer than every
sequence here, and once with a window of 8), internvl2-1b (vlm, 8
frontend tokens) and seamless-m4t-medium (audio: the encoder-decoder) at
``.smoke()`` (2 layers, d_model 128, float32) against the reference.  The
reference's weights cross over with ``params_from_jax``; tokens and the
frontend embeddings come from ``numpy.random.default_rng``, and one numpy
frontend goes to both packages.

Tolerances, each with its reason:

- forward logits at 1e-5: the same f32 arithmetic summed in another
  order;
- the loss at 1e-5 relative and the grads at 1e-5 of each leaf's largest
  |grad| (as ``tests/test_torch_train.py``): the same; except the
  encoder-decoder's cross-attention ``wq`` and ``wk`` at 2e-5
  (``XATTN_GRAD_TOL``): their grads (largest ~1e-4) are small
  differences of larger terms, and against the same port run in float64
  each package's f32 grad lies 7e-6 to 9.4e-6 of the leaf's largest
  away, in opposite directions (seen: 1.41e-5 between them on ``wq``);
- decode logits at 1e-3 and the bf16 caches (K/V, the SSM conv window,
  the encoder states) at one bf16 step, 2^-7 relative, step by step from
  the reference's own cache (as ``tests/test_torch_lm.py``: an f32 value
  within ~1e-6 of a bf16 rounding midpoint rounds either way); the f32
  SSM state at 1e-5; under ``kv_quant`` the int8 rows one LSB apart on
  at most 1e-3 of a step's entries (rounding ties, as
  ``tests/test_torch_int8_kv.py``);
- the serving engines' tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.train.step import make_prefill_step as ref_prefill_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import api
from repro_torch.models.convert import (by_reference_leaf, cache_from_jax,
                                        cache_to_numpy, params_from_jax,
                                        params_to_numpy)
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.models.frontends import synthetic_frontend
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.train.step import make_prefill_step

BATCH, SEQ = 2, 32
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
XATTN_GRAD_TOL = 2e-5
DECODE_TOL = 1e-3
STATE_TOL = 1e-5
BF16_STEP = 2.0 ** -7


# ------------------------------------------- the reference's smoke tests
def _inputs(cfg, batch=BATCH, seq=SEQ, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq))
    return (torch.from_numpy(toks), torch.from_numpy(np.roll(toks, -1, 1)),
            synthetic_frontend(cfg, batch, device="cpu"))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_shapes_and_finiteness(name):
    cfg = get_arch(name).smoke()
    params = api.init_params(0, cfg, device="cpu")
    tokens, _, frontend = _inputs(cfg)
    logits = api.forward(params, tokens, cfg, frontend)
    S_out = SEQ + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (BATCH, S_out, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), f"{name}: non-finite logits"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_grad_finite(name):
    cfg = get_arch(name).smoke()
    params = api.init_params(1, cfg, device="cpu")
    tokens, targets, frontend = _inputs(cfg)
    val = api.loss_fn(params, tokens, targets, cfg, frontend)
    assert bool(torch.isfinite(val)), f"{name}: non-finite loss {val}"
    grads = torch.autograd.grad(val, list(params.parameters()))
    assert grads, "no grads"
    for g in grads:
        assert bool(torch.isfinite(g).all()), f"{name}: non-finite grad"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_step(name):
    cfg = get_arch(name).smoke()
    assert cfg.supports_decode
    params = api.init_params(2, cfg, device="cpu")
    cache = api.init_cache(cfg, BATCH, max_len=64, device="cpu")
    tok = torch.zeros(BATCH, 1, dtype=torch.int32)
    logits, cache = api.decode_step(params, tok, cache, cfg)
    assert logits.shape == (BATCH, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    logits2, cache = api.decode_step(params, tok, cache, cfg)
    assert bool(torch.isfinite(logits2).all())
    assert int(cache["pos"][0]) == 2


# ------------------------------------------ the new families, against it
CASES = {
    "granite-moe-3b-a800m": {},
    "qwen3-moe-30b-a3b": {},
    "hymba-1.5b": {},
    "hymba-1.5b window 8": dict(sliding_window=8),
    "internvl2-1b": {},
    "seamless-m4t-medium": {},
}


def _cfgs(case, **kw):
    name = case.split()[0]
    kw = {**CASES[case], **kw}
    return ref_arch(name).smoke().replace(**kw), \
        get_arch(name).smoke().replace(**kw)


_MODELS = {}


def _model(case, **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    key = (case, tuple(sorted(kw.items())))
    if key not in _MODELS:
        rcfg, tcfg = _cfgs(case, **kw)
        rp = ref_api.init_params(jax.random.PRNGKey(len(case)), rcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
        _MODELS[key] = (rcfg, rp, tcfg, tp)
    return _MODELS[key]


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _frontend(cfg, batch, seed=0):
    """One numpy frontend for both packages (``None`` without one)."""
    if not cfg.frontend_tokens:
        return None
    return (np.random.default_rng(100 + seed).standard_normal(
        (batch, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _both(fe):
    return (None, None) if fe is None else (jnp.asarray(fe),
                                            torch.from_numpy(fe))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _grad_tol(path):
    where = jax.tree_util.keystr(path)
    if where in ("['dec_layers']['xattn']['wq']",
                 "['dec_layers']['xattn']['wk']"):
        return XATTN_GRAD_TOL
    return GRAD_TOL


def _close_leafwise(got, want, what):
    """Every leaf of ``got`` within its tolerance (:func:`_grad_tol`) of
    ``want``, relative to the leaf's largest |entry|; the two trees have
    the same paths."""
    g, w = _leaves(got), _leaves(_f32(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (what, path)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        assert err <= _grad_tol(path), \
            f"{what} {jax.tree_util.keystr(path)}: {err:.3g}"


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_the_reference(case):
    rcfg, rp, tcfg, tp = _model(case)
    toks = _tokens(rcfg, (2, SEQ))
    r_fe, t_fe = _both(_frontend(rcfg, 2))
    want = np.asarray(ref_api.forward(rp, jnp.asarray(toks), rcfg, r_fe))
    got = api.forward(tp, torch.from_numpy(toks), tcfg, t_fe).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_the_reference(case, remat):
    rcfg, rp, tcfg, tp = _model(case, remat=remat)
    toks = _tokens(rcfg, (2, SEQ), seed=1)
    tg = np.roll(toks, -1, 1)
    fe = _frontend(rcfg, 2, seed=1)
    r_fe, t_fe = _both(fe)
    r_loss, r_grads = jax.value_and_grad(lambda p: ref_api.loss_fn(
        p, jnp.asarray(toks), jnp.asarray(tg), rcfg, r_fe))(rp)
    t_loss = api.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tg),
                         tcfg, t_fe)
    assert t_loss.dtype == torch.float32 and t_loss.requires_grad
    np.testing.assert_allclose(t_loss.item(), float(r_loss), rtol=LOSS_RTOL)
    assert abs(float(r_loss) - np.log(rcfg.vocab_size)) < 0.5
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(t_loss,
                                                list(named.values()))))
    _close_leafwise(params_to_numpy(grads, tcfg), r_grads, f"{case} grads")


def _reference_cache(rcfg, rp, batch, max_len, fe):
    """The reference's fresh cache; for the encoder-decoder, ``enc`` holds
    the encoder states of ``fe`` (bf16, as the cache keeps them)."""
    rc = ref_api.init_cache(rcfg, batch, max_len)
    if rcfg.family == "audio":
        rc["enc"] = ref_encdec.encode(rp, jnp.asarray(fe), rcfg).astype(
            jnp.bfloat16)
    return rc


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_the_reference_step_by_step(case):
    """Each step starts from the reference's cache (``cache_from_jax``), so
    one step's differences do not carry into the next; every cache leaf
    is compared after each step."""
    rcfg, rp, tcfg, tp = _model(case)
    toks = _tokens(rcfg, (2, 10), seed=2)
    rc = _reference_cache(rcfg, rp, 2, 12, _frontend(rcfg, 2, seed=2))
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        tc = cache_from_jax(jax.tree.map(np.asarray, rc), device="cpu")
        lg_t, tc2 = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tc, tcfg)
        assert tc2 is tc
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        got, want = _leaves(cache_to_numpy(tc)), _leaves(_f32(rc))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            where = jax.tree_util.keystr(path)
            if where == "['ssm']['state']":
                np.testing.assert_allclose(a, b, rtol=STATE_TOL,
                                           atol=STATE_TOL, err_msg=where)
            else:
                np.testing.assert_allclose(a, b, rtol=BF16_STEP, atol=1e-6,
                                           err_msg=where)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b", "hymba-1.5b",
                                  "internvl2-1b", "seamless-m4t-medium"])
def test_full_width_layout_is_the_references(name):
    """At published widths (on the meta device; the reference's through
    ``jax.eval_shape``): every reference leaf, its stacked shape (granite:
    40 experts padded to 48; hymba: 50 SSM heads of 64)."""
    cfg = get_arch(name)
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"):
            tuple(a.shape) for k, a in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: ref_api.init_params(
                    jax.random.PRNGKey(0), ref_arch(name))))[0]}
    params = (EncDec if cfg.family == "audio" else LM)(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    got = {k: shapes[k] if ns == [k] else (len(ns), *shapes[ns[0]])
           for k, ns in by_reference_leaf(shapes).items()}
    assert got == want
    if name == "granite-moe-3b-a800m":
        assert got["layers.moe.w_gate"] == (32, 48, 1536, 512)
    if name == "hymba-1.5b":
        assert got["layers.ssm.a_log"] == (32, 50)


def test_init_cache_has_the_references_layout():
    for case in ("hymba-1.5b", "seamless-m4t-medium", "granite-moe-3b-a800m"):
        rcfg, tcfg = _cfgs(case)
        want = _leaves(ref_api.init_cache(rcfg, 3, 8))
        got = _leaves(api.init_cache(tcfg, 3, 8, device="cpu"))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape, (case, path)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (case, path)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_step_matches_the_reference(case):
    rcfg, rp, tcfg, tp = _model(case)
    toks = _tokens(rcfg, (2, 16), seed=3)
    fe = _frontend(rcfg, 2, seed=3)
    r_batch = {"tokens": jnp.asarray(toks)}
    t_batch = {"tokens": torch.from_numpy(toks)}
    if fe is not None:
        r_batch["frontend"] = jnp.asarray(fe)
        t_batch["frontend"] = fe            # numpy: the step moves it
    want = jax.jit(ref_prefill_step(rcfg))(rp, r_batch)
    got = make_prefill_step(tcfg)(tp, t_batch)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input (see
    ``tests/test_torch_lm.py``: the reference's engine may alias its token
    buffer on the CPU)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(np.array(a, copy=True), *args, **kw)


@pytest.fixture
def ref_engines(monkeypatch):
    monkeypatch.setattr(ref_engine, "jnp", _CopyingJnp())
    return ref_engine


@pytest.mark.parametrize("case", list(CASES))
def test_engines_tokens_match_the_reference(case, ref_engines):
    """``ServeEngine.generate`` and ``ContinuousBatchingEngine.run`` (five
    requests over two slots), no frontend, as the reference's engines
    serve: the encoder-decoder decodes against its zeroed ``enc``."""
    rcfg, rp, tcfg, tp = _model(case)
    prompts = _tokens(rcfg, (2, 5), seed=4)
    want = ref_engines.ServeEngine(rcfg, rp, 2, 32).generate(prompts, 6)
    got = ServeEngine(tcfg, tp, 2, 32).generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, rcfg.vocab_size, (4,)) for _ in range(5)]
    want = ref_engines.ContinuousBatchingEngine(rcfg, rp, 2, 32).run(
        requests, 4)
    got = ContinuousBatchingEngine(tcfg, tp, 2, 32).run(requests, 4)
    assert got == want and len(got) == 5


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "hymba-1.5b",
                                  "internvl2-1b", "seamless-m4t-medium"])
def test_launchers_run_the_family_on_the_cpu(name, tmp_path, monkeypatch,
                                             capsys):
    """``launch.train`` (2 steps, the data pipeline's numpy frontend for
    vlm and audio, a checkpoint) takes the train lane: no call of the
    flash-attention wrapper; ``launch.serve``'s prefill calls it once per
    (decoder) attention layer."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve, train

    calls = []
    wrapped = fa_ops.flash_attention_bhsd
    monkeypatch.setattr(fa_ops, "flash_attention_bhsd",
                        lambda *a, **kw: calls.append(1) or wrapped(*a, **kw))
    out = train.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert calls == []
    assert (tmp_path / out["cfg"].name / "step_000000000002").is_dir()
    serve.main(["--arch", name, "--smoke", "--device", "cpu", "--gen-len",
                "3"])
    assert len(calls) == out["cfg"].num_layers
    assert "generated 12 tokens" in capsys.readouterr().out


def test_the_new_entry_points_default_to_the_card():
    """Like every entry point of the port, the new ones default to
    ``device="cuda"`` and raise without a card instead of handing out
    CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    from repro_torch.models import encdec, ssm
    gen = torch.Generator().manual_seed(0)
    audio = get_arch("seamless-m4t-medium").smoke()
    hybrid = get_arch("hymba-1.5b").smoke()
    for call in (lambda: encdec.init_params(gen, audio),
                 lambda: encdec.init_cache(audio, 1, 8),
                 lambda: api.init_params(0, audio),
                 lambda: api.init_cache(hybrid, 1, 8),
                 lambda: ssm.init_ssm_cache(hybrid, 1, 1),
                 lambda: synthetic_frontend(audio, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("case", ["granite-moe-3b-a800m",
                                  "seamless-m4t-medium"])
def test_compressed_train_step_matches_the_reference(case):
    """``make_train_step(grad_compression=True)`` in f32 takes one int8
    scale per leaf of the reference's stacked tree (``by_reference_leaf``:
    the MoE's [L, E, d, f] experts, the encoder's and decoder's layers),
    so one step from step 150 gives the reference's loss and, up to int8
    ties (one step of 1/127 of a leaf's scale on a few entries), its
    grad norm."""
    from repro.optim import adamw as ref_adamw
    from repro.train import step as ref_step
    from repro_torch.models.convert import adamw_from_jax
    from repro_torch.train import step as tstep

    rcfg, rp, tcfg, _ = _model(case)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    names = [n for n, _ in tp.named_parameters()]
    assert len(by_reference_leaf(names)) == len(jax.tree.leaves(rp))
    rs = ref_adamw.init_adamw(rp)._replace(step=jnp.asarray(150, jnp.int32))
    ts = adamw_from_jax(jax.tree.map(np.asarray, rs), tcfg, device="cpu")
    kw = dict(cast_bf16=False, grad_compression=True)
    toks = _tokens(rcfg, (2, SEQ), seed=6)
    fe = _frontend(rcfg, 2, seed=6)
    r_batch = {"tokens": jnp.asarray(toks),
               "targets": jnp.asarray(np.roll(toks, -1, 1))}
    t_batch = {"tokens": torch.from_numpy(toks),
               "targets": torch.from_numpy(np.roll(toks, -1, 1))}
    if fe is not None:
        r_batch["frontend"], t_batch["frontend"] = jnp.asarray(fe), fe
    _, _, rm = ref_step.make_train_step(rcfg, **kw)(rp, rs, r_batch)
    _, _, tm = tstep.make_train_step(tcfg, **kw)(tp, ts, t_batch)
    np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(rm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("case", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_int8_decode_matches_the_reference(case):
    """``kv_quant`` on the moe and hybrid families: each step from the
    reference's int8 cache, logits at 1e-3; the int8 K/V rows as
    ``tests/test_torch_int8_kv.py`` holds them (at most 1e-3 of the new
    entries one LSB off, at rounding ties of the f32 projection); the
    hybrid's f32 SSM state at 1e-5."""
    rcfg, rp, tcfg, tp = _model(case, kv_quant=True)
    toks = _tokens(rcfg, (2, 6), seed=7)
    rc = ref_api.init_cache(rcfg, 2, 8)
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        tc = cache_from_jax(jax.tree.map(np.asarray, rc), device="cpu")
        assert tc["k"].dtype == torch.int8
        lg_t, tc = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, tcfg)
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        got, want = cache_to_numpy(tc), _f32(rc)
        for kv in ("k", "v"):
            d = np.abs(got[kv].astype(np.int32) - want[kv].astype(np.int32))
            assert d.max() <= 1 and (d > 0).sum() <= max(
                1, 1e-3 * d[:, :, t].size), (case, kv, t)
        if "ssm" in got:
            np.testing.assert_allclose(got["ssm"]["state"],
                                       want["ssm"]["state"], rtol=STATE_TOL,
                                       atol=STATE_TOL)
