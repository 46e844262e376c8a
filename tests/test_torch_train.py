"""PyTorch port, training on the carried families (dense and ssm), against
the reference on the CPU.

The reference's weights cross over with ``params_from_jax``; grads, AdamW
moments and updated weights come back with ``params_to_numpy`` /
``adamw_to_numpy`` and are compared leaf by leaf in the reference's
layout.  Tokens come from ``numpy.random.default_rng``.  The smoke configs
(2 layers, d_model 128, float32 compute) of smollm-135m, gemma2-2b (logit
and attention softcaps, post norms, a sliding window of 8 on alternating
layers), minicpm-2b (WSD schedule) and xlstm-1.3b; S 16 takes the masked
attention and the direct CE, S 1024 the chunked attention (512-query
blocks) and the chunked head + CE.  Both run with ``remat`` off (the smoke
default) and on (per-layer ``torch.utils.checkpoint``).

Tolerances, each with its reason:

- ``LOSS_RTOL`` 1e-5: the same f32 arithmetic summed in another order
  (seen: up to 2.3e-7 relative);
- ``GRAD_TOL`` 1e-5 of each leaf's largest |grad|: the same (seen: up to
  1.6e-6); the port's leaves follow ``named_parameters()``, the
  reference's its sorted keys, so global sums add in another order too;
- the train step in f32 (``cast_bf16=False``): loss, grad norm and
  moments at ``STEP_TOL`` 1e-5 (moments relative to each leaf's largest
  entry; seen 3.1e-6), and each step's update of the weights at
  ``UPDATE_TOL`` 1e-4 of the leaf's largest update on all but 1e-3 of the
  entries (at least one), those within 1e-2: AdamW's update is
  normalised, so an entry whose gradient is near zero carries the
  gradient's f32 rounding at about its own size (seen: 5.2e-3 on one
  entry of 16 384);
- with ``grad_compression`` (f32) the int8 rounding of a gradient entry
  at a tie flips one step (1/127 of the reference leaf's scale) in a few
  entries: moments at ``STEP_TOL`` except at most 1e-3 of the entries,
  those within 2/127; updates as in f32 except that a flipped entry may
  move by up to the leaf's largest update;
- under ``cast_bf16`` the loss still runs on bit-equal bf16 weights (loss
  at ``LOSS_RTOL``), but each bf16 copy's gradient is rounded to bf16 and
  accumulated in bf16 where a weight is used more than once (the tied
  embedding; the reference's sLSTM weights across its time scan), in an
  order each framework picks: the grad norm at 1e-4 relative, the moments
  within one bf16 step (``BF16_STEP`` 2^-7) of each leaf's largest entry
  except at most 20 % of the entries, those within 2^-4; and AdamW's
  update, sign-like where two steps' gradients nearly cancel, within
  2^-7 of the leaf's largest update on 90 % of the entries and within
  twice it on the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedules as ref_sched
from repro.train import step as ref_step
from repro_torch.configs import get_arch
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bhsd
from repro_torch.models import api, lm
from repro_torch.models.attention import QCHUNK
from repro_torch.models.convert import (adamw_from_jax, adamw_to_numpy,
                                        params_from_jax, params_to_numpy)
from repro_torch.optim import adamw, compression, schedules
from repro_torch.train import step as tstep

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
UPDATE_TOL = 1e-4
BF16_STEP = 2.0 ** -7
BF16_LOOSE = 2.0 ** -4

CASES = {
    "smollm-135m": {},
    "gemma2-2b": dict(sliding_window=8, local_global_pattern=True),
    "minicpm-2b": {},
    "xlstm-1.3b": {},
}


def _cfgs(name, **kw):
    kw = {**CASES[name], **kw}
    return ref_arch(name).smoke().replace(**kw), \
        get_arch(name).smoke().replace(**kw)


def _params(name, **kw):
    rcfg, tcfg = _cfgs(name, **kw)
    rp = ref_api.init_params(jax.random.PRNGKey(len(name)), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _batch(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return toks, np.roll(toks, -1, axis=1)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _close_leafwise(got, want, tol, what, frac=0.0, loose=None):
    """Every leaf of ``got`` within ``tol`` of ``want``, relative to the
    leaf's largest |entry|, except at most a fraction ``frac`` of its
    entries (at least one entry when ``frac`` > 0), which must still be
    within ``loose`` (counted and bounded); the two trees have the same
    paths."""
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, path)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = np.abs(a - b) / scale
        where = f"{what} {jax.tree_util.keystr(path)}"
        off = int((err > tol).sum())
        allowed = max(frac * err.size, 1) if frac else 0
        assert off <= allowed, f"{where}: {off} of {err.size} entries off " \
            f"by more than {tol:.3g} (max {err.max():.3g}), allowed " \
            f"{allowed:.3g}"
        if off:
            assert err.max() <= loose, f"{where}: {err.max():.3g} > {loose}"


# -------------------------------------------------------------- loss, grads
_RUNS = {}


def _loss_and_grads(name, S, remat):
    """(reference loss, its grads, port loss, port grads in the reference's
    layout), computed once for each case."""
    key = (name, S, remat)
    if key not in _RUNS:
        rcfg, rp, tcfg, tp = _params(name, remat=remat)
        toks, tg = _batch(rcfg, 2, S, seed=S)
        r_loss, r_grads = jax.value_and_grad(lambda p: ref_api.loss_fn(
            p, jnp.asarray(toks), jnp.asarray(tg), rcfg))(rp)
        t_loss = api.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tg),
                             tcfg)
        named = dict(tp.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(t_loss,
                                                    list(named.values()))))
        _RUNS[key] = (float(r_loss), r_grads, t_loss,
                      params_to_numpy(grads, tcfg))
    return _RUNS[key]


LOSS_CASES = [(n, S, r) for n in CASES for S in (16, 1024)
              for r in (False, True)]


@pytest.mark.parametrize("name,S,remat", LOSS_CASES)
def test_loss_matches_the_reference(name, S, remat):
    r_loss, _, t_loss, _ = _loss_and_grads(name, S, remat)
    assert t_loss.dtype == torch.float32 and t_loss.dim() == 0
    assert t_loss.requires_grad
    np.testing.assert_allclose(t_loss.item(), r_loss, rtol=LOSS_RTOL)
    # a fresh model's loss sits near ln(vocab)
    assert abs(r_loss - np.log(512)) < 0.5


@pytest.mark.parametrize("name,S,remat", LOSS_CASES)
def test_grads_match_the_reference_leaf_by_leaf(name, S, remat):
    _, r_grads, _, t_grads = _loss_and_grads(name, S, remat)
    _close_leafwise(t_grads, r_grads, GRAD_TOL, f"{name} S={S} grads")


def test_the_lanes_are_the_references_thresholds():
    assert QCHUNK == 512 and lm.CE_CHUNK == ref_lm.CE_CHUNK == 512


def test_chunked_head_ce_matches_the_direct_ce():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1024, 16)).astype(np.float32)
    head = rng.standard_normal((16, 300)).astype(np.float32)
    tg = rng.integers(0, 290, (2, 1024))
    got = lm.chunked_head_ce(torch.from_numpy(x), torch.from_numpy(head),
                             torch.from_numpy(tg), 30.0, 290)
    want = ref_lm.chunked_head_ce(jnp.asarray(x), jnp.asarray(head),
                                  jnp.asarray(tg), 30.0, 290)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    logits = lm.mask_vocab_pad(30.0 * torch.tanh(
        torch.from_numpy(x @ head) / 30.0), 290)
    np.testing.assert_allclose(
        got.item(), lm.cross_entropy(logits, torch.from_numpy(tg)).item(),
        rtol=LOSS_RTOL)


# ------------------------------------------------------------- kernel lane
@pytest.mark.parametrize("name", ["smollm-135m", "xlstm-1.3b"])
def test_the_kernel_lane_raises_on_tensors_that_require_grad(name):
    """Serving's lane runs the hand-written kernels, which have no
    backward: handed trainable weights under grad it raises instead of
    returning outputs with no ``grad_fn``.  Under no_grad (the serving
    entry points) it runs."""
    _, _, tcfg, tp = _params(name)
    toks = torch.from_numpy(_batch(tcfg, 1, 16)[0])
    before = (_cuda.FLASH.launches, _cuda.MLSTM.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        lm.hidden_forward(tp, toks, tcfg)
    with pytest.raises(ValueError, match="lane"):
        lm.hidden_forward(tp, toks, tcfg, lane="xla")
    with torch.no_grad():
        assert lm.hidden_forward(tp, toks, tcfg).shape == (1, 16, 128)
    assert not api.forward(tp, toks, tcfg).requires_grad
    assert (_cuda.FLASH.launches, _cuda.MLSTM.launches) == before


def test_the_kernel_wrappers_refuse_inputs_that_require_grad():
    q = torch.randn(2, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash-attention kernel has no"):
        flash_attention_bhsd(q, q.detach(), q.detach())
    v = torch.randn(2, 8, 33)
    ig = torch.rand(2, 8)
    with pytest.raises(RuntimeError, match="chunked-mLSTM kernel has no"):
        mlstm_chunk_bhsd(q, q.detach(), v, ig, -ig, chunk=8)
    with torch.no_grad():
        assert flash_attention_bhsd(q, q, q).shape == (2, 8, 32)


# ---------------------------------------------------------------- optimizer
def _rand_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(2)
    g = _rand_tree(rng, SHAPES)
    for max_norm in (0.5, 1e3):
        got, gn = adamw.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        want, wn = ref_adamw.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), max_norm)
        np.testing.assert_allclose(gn.item(), float(wn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        adamw.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
        .item(), np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in g.values())), rtol=1e-6)


def test_two_adamw_updates_match_the_reference():
    """Two updates from a fresh state (bias correction at t = 1 and 2),
    the second at another lr; weight decay on every leaf."""
    rng = np.random.default_rng(3)
    p = _rand_tree(rng, SHAPES)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ts, rs, rp = adamw.init_adamw(tp), ref_adamw.init_adamw(
        jax.tree.map(jnp.asarray, p)), jax.tree.map(jnp.asarray, p)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for i, lr in enumerate((1e-2, 3e-2)):
        g = _rand_tree(rng, SHAPES)
        tp, ts = adamw.adamw_update({k: torch.from_numpy(v)
                                     for k, v in g.items()}, ts, tp,
                                    torch.tensor(lr))
        rp, rs = ref_adamw.adamw_update(jax.tree.map(jnp.asarray, g), rs,
                                        rp, jnp.float32(lr))
        assert int(ts.step) == int(rs.step) == i + 1
        for k in p:
            for got, want in ((tp[k], rp[k]), (ts.mu[k], rs.mu[k]),
                              (ts.nu[k], rs.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
    # the reference's constants (not torch.optim.AdamW's): at t = 1 with a
    # zero gradient only the decay moves a weight, by lr * 0.1 * w
    z = {"w": torch.ones(2)}
    out, _ = adamw.adamw_update({"w": torch.zeros(2)}, adamw.init_adamw(z),
                                z, 1.0)
    np.testing.assert_allclose(out["w"].numpy(), 1.0 - 0.1, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 8099, 8100,
                                  8500, 9099, 9100, 9999, 12000])
def test_schedules_match_the_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    np.testing.assert_allclose(
        schedules.cosine_schedule(torch.tensor(step), **kw).item(),
        float(ref_sched.cosine_schedule(jnp.asarray(step), **kw)),
        rtol=1e-6, atol=1e-12)
    kw = dict(peak_lr=3e-4, warmup_steps=100, stable_steps=8000,
              decay_steps=1000)
    np.testing.assert_allclose(
        schedules.wsd_schedule(torch.tensor(step, dtype=torch.int32),
                               **kw).item(),
        float(ref_sched.wsd_schedule(jnp.asarray(step, jnp.int32), **kw)),
        rtol=1e-6, atol=1e-12)
    for name in ("minicpm-2b", "smollm-135m"):
        np.testing.assert_allclose(
            tstep.lr_for(get_arch(name), torch.tensor(step)).item(),
            float(ref_step.lr_for(ref_arch(name), jnp.asarray(step))),
            rtol=1e-6, atol=1e-12)


def test_compress_and_decompress_match_the_reference():
    rng = np.random.default_rng(4)
    g = _rand_tree(rng, SHAPES)
    res = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
           for k, s in SHAPES.items()}
    q, sc, nr = compression.compress(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in res.items()})
    rq, rsc, rnr = ref_comp.compress(jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, res))
    d = compression.decompress(q, sc)
    rd = ref_comp.decompress(rq, rsc)
    for k in g:
        assert q[k].dtype == torch.int8 and sc[k].dim() == 0
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
        np.testing.assert_allclose(sc[k].item(), float(rsc[k]), rtol=1e-7)
        np.testing.assert_allclose(nr[k].numpy(), np.asarray(rnr[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(d[k].numpy(), np.asarray(rd[k]),
                                   rtol=1e-7, atol=0)
    zero = compression.init_residuals({k: torch.from_numpy(v)
                                       for k, v in g.items()})
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in zero.values())


# --------------------------------------------------------------- train step
# (tol, fraction of entries allowed past tol, bound on those) relative to
# each leaf's largest |entry|, for the AdamW moments and for each step's
# weight update; the module docstring gives the reasons
STEP_TOLS = {
    "f32": dict(mom=(STEP_TOL, 0.0, None),
                upd=(UPDATE_TOL, 1e-3, 1e-2)),
    "int8": dict(mom=(STEP_TOL, 1e-3, 2 / 127),
                 upd=(UPDATE_TOL, 1e-3, 1.0)),
    "bf16": dict(mom=(BF16_STEP, 0.2, BF16_LOOSE),
                 upd=(BF16_STEP, 0.1, 2.0)),
}
STEP_CASES = {
    "smollm f32": ("smollm-135m", "f32", dict(cast_bf16=False)),
    "smollm bf16": ("smollm-135m", "bf16", dict(cast_bf16=True)),
    "smollm compressed": ("smollm-135m", "int8", dict(
        cast_bf16=False, grad_compression=True)),
    "minicpm bf16 (WSD)": ("minicpm-2b", "bf16", dict(cast_bf16=True)),
    "xlstm f32": ("xlstm-1.3b", "f32", dict(cast_bf16=False)),
    "xlstm bf16": ("xlstm-1.3b", "bf16", dict(cast_bf16=True)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_train_steps_match_the_reference(case):
    """Two ``make_train_step`` steps from a state at step 150, past the
    warm-up: a fresh state's first update has lr 0 and would pass without
    moving a weight.  Each step is held on loss, grad norm, lr, the AdamW
    state and the update of every weight, in the reference's layout."""
    name, kind, kw = STEP_CASES[case]
    mom, upd = STEP_TOLS[kind]["mom"], STEP_TOLS[kind]["upd"]
    rcfg, rp, tcfg, tp = _params(name)
    rs = ref_adamw.init_adamw(rp)._replace(step=jnp.asarray(150, jnp.int32))
    ts = adamw_from_jax(jax.tree.map(np.asarray, rs), tcfg, device="cpu")
    assert int(ts.step) == 150
    r_step = jax.jit(ref_step.make_train_step(rcfg, **kw))
    t_step = tstep.make_train_step(tcfg, **kw)
    for i in range(2):
        toks, tg = _batch(rcfg, 2, 32, seed=10 + i)
        r_before = jax.tree.map(np.asarray, rp)
        t_before = params_to_numpy(tp, tcfg)
        rp, rs, rm = r_step(rp, rs, {"tokens": jnp.asarray(toks),
                                     "targets": jnp.asarray(tg)})
        tp2, ts, tm = t_step(tp, ts, {"tokens": torch.from_numpy(toks),
                                      "targets": torch.from_numpy(tg)})
        assert tp2 is tp
        np.testing.assert_allclose(tm["loss"].item(), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(rm["grad_norm"]),
                                   rtol=1e-4 if kind == "bf16" else STEP_TOL)
        got = adamw_to_numpy(ts, tcfg)
        assert got["step"] == int(rs.step) == 151 + i
        _close_leafwise(got["mu"], rs.mu, mom[0], f"{case} mu", *mom[1:])
        _close_leafwise(got["nu"], rs.nu, mom[0], f"{case} nu", *mom[1:])
        _close_leafwise(
            jax.tree.map(np.subtract, params_to_numpy(tp, tcfg), t_before),
            jax.tree.map(np.subtract, jax.tree.map(np.asarray, rp),
                         r_before), upd[0], f"{case} updates", *upd[1:])
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in tp.parameters())


def test_init_train_state_and_constrain_are_one_device():
    cfg = get_arch("smollm-135m").smoke()
    params, opt = tstep.init_train_state(0, cfg, device="cpu")
    assert int(opt.step) == 0 and set(opt.mu) == set(
        n for n, _ in params.named_parameters())
    assert all(float(m.abs().max()) == 0 for m in opt.mu.values())
    tree = {"a": torch.ones(2)}
    assert tstep.constrain_like_params(tree) is tree
    assert tstep.constrain_like_params(tree) is \
        ref_step.constrain_like_params(tree)
