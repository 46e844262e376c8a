"""PyTorch port, hymba-1.5b's hybrid blocks (``models/ssm.py``: the SSD
scan, the SSM block and its decode step) on the CPU, against the
reference.

(``tests/test_torch_hybrid.py`` is the simulator's hybrid replay.)  The
reference's weights cross over with ``params_from_jax``; inputs come from
``numpy.random.default_rng``.  hymba-1.5b at ``.smoke()``: 2 layers,
d_model 128, 4/2 heads, d_inner 256 (4 SSM heads of 64), N 8, chunk 16,
float32; its window of 1024 is longer than every sequence here, so the
window is also run at 8.

Tolerances, each with its reason:

- ``ssd_scan``, ``ssm_forward`` and the decode step at 1e-5: the same
  f32 arithmetic summed in another order;
- the bf16 conv window at one bf16 step (2^-7 relative): an f32 value
  near a bf16 rounding midpoint rounds either way;
- decode against forward at the reference's own 3e-2
  (``tests/test_arch_smoke.py::test_decode_matches_forward_hybrid``):
  decode rounds the conv window and the K/V cache through bf16.

The repair: the reference's ``ssd_scan`` exponentiates the positive
differences above the diagonal before dropping them, which overflows at
chunk 256 and makes its backward NaN; the port masks first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_arch
from repro_torch.models import api, ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ContinuousBatchingEngine

TOL = 1e-5
BF16_STEP = 2.0 ** -7
CONSISTENCY_TOL = 3e-2


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg, tcfg = ref_arch("hymba-1.5b").smoke(), get_arch("hymba-1.5b").smoke()
    rp = ref_api.init_params(jax.random.PRNGKey(9), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _scan_inputs(Bb, S, H, P, N, seed=0, dt=None, a=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((Bb, S, H, P)).astype(f)
    if dt is None:
        dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(f)
    if a is None:
        a = -np.exp(0.5 * rng.standard_normal(H)).astype(f)
    B = rng.standard_normal((Bb, S, N)).astype(f)
    C = rng.standard_normal((Bb, S, N)).astype(f)
    return [np.broadcast_to(np.asarray(v, f), s).copy() for v, s in
            ((u, (Bb, S, H, P)), (dt, (Bb, S, H)), (a, (H,)),
             (B, (Bb, S, N)), (C, (Bb, S, N)))]


@pytest.mark.parametrize("d_inner", [3200, 256, 200, 96, 8])
def test_heads_for_is_the_references(d_inner):
    assert ssm._heads_for(d_inner) == ref_ssm._heads_for(d_inner)
    assert ssm._heads_for(3200) == (50, 64)


@pytest.mark.parametrize("S,chunk", [(64, 16), (16, 16), (12, 64), (48, 8)])
def test_ssd_scan_matches_the_reference(S, chunk):
    ins = _scan_inputs(2, S, 3, 8, 5, seed=S + chunk)
    want = np.asarray(ref_ssm.ssd_scan(*map(jnp.asarray, ins), chunk))
    got = ssm.ssd_scan(*map(torch.from_numpy, ins), chunk).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_ssd_scan_rejects_a_sequence_the_chunk_does_not_divide():
    ins = _scan_inputs(1, 24, 2, 8, 4)
    with pytest.raises(AssertionError, match="must divide chunk"):
        ssm.ssd_scan(*map(torch.from_numpy, ins), 16)


def test_masked_exponential_repairs_the_references_nan_backward():
    """At chunk 256 with dt = softplus(0) and a = -1 the differences above
    the diagonal reach ~176: ``exp`` overflows f32.  The reference's
    forward drops them with ``where`` (right), but its backward is
    0 * inf = NaN; the port masks before the exponential.  Its forward
    equals the reference's and its grads are finite."""
    S = c = 256
    ins = _scan_inputs(1, S, 2, 8, 4, seed=1,
                       dt=np.log1p(np.exp(np.float32(0.0))), a=-1.0)
    r = list(map(jnp.asarray, ins))

    def r_sum(u, dt):
        return ref_ssm.ssd_scan(u, dt, r[2], r[3], r[4], c).sum()

    r_out = np.asarray(ref_ssm.ssd_scan(*r, c))
    r_gu, r_gdt = jax.grad(r_sum, argnums=(0, 1))(r[0], r[1])
    assert np.isfinite(r_out).all()
    assert np.isnan(np.asarray(r_gdt)).any()       # the reference's fault

    t = [torch.from_numpy(v) for v in ins]
    t[0].requires_grad_(True)
    t[1].requires_grad_(True)
    out = ssm.ssd_scan(*t, c)
    g_u, g_dt = torch.autograd.grad(out.sum(), [t[0], t[1]])
    np.testing.assert_allclose(out.detach().numpy(), r_out, rtol=TOL,
                               atol=TOL * float(np.abs(r_out).max()))
    assert bool(torch.isfinite(g_u).all()) and bool(torch.isfinite(g_dt).all())
    # where the reference's grads are finite, they are the port's
    fin = np.isfinite(np.asarray(r_gu))
    np.testing.assert_allclose(g_u.numpy()[fin], np.asarray(r_gu)[fin],
                               rtol=1e-4, atol=1e-4 * float(
                                   np.abs(np.asarray(r_gu)[fin]).max()))


def test_ssd_scan_grads_match_the_reference_below_overflow():
    """At the smoke config's chunk (16) nothing overflows: grads of a
    weighted sum of the output equal the reference's."""
    ins = _scan_inputs(2, 32, 3, 8, 5, seed=3)
    w = np.random.default_rng(4).standard_normal((2, 32, 3, 8)).astype(
        np.float32)
    r = list(map(jnp.asarray, ins))
    want = jax.grad(lambda *a: (ref_ssm.ssd_scan(*a, 16) * w).sum(),
                    argnums=(0, 1, 2, 3, 4))(*r)
    t = [torch.from_numpy(v).requires_grad_(True) for v in ins]
    got = torch.autograd.grad((ssm.ssd_scan(*t, 16)
                               * torch.from_numpy(w)).sum(), t)
    for g, wg in zip(got, want):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=TOL,
                                   atol=TOL * float(np.abs(wg).max()))


def _ssm_layer(model):
    rcfg, rp, tcfg, tp = model
    return jax.tree.map(lambda a: a[0], rp["layers"]["ssm"]), tp.layers[0].ssm


@pytest.mark.parametrize("S", [16, 48])
def test_ssm_forward_matches_the_reference(model, S):
    rcfg, _, tcfg, _ = model
    r_ssm, t_ssm = _ssm_layer(model)
    x = np.random.default_rng(S).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    want = np.asarray(ref_ssm.ssm_forward(r_ssm, jnp.asarray(x), rcfg))
    with torch.no_grad():
        got = ssm.ssm_forward(t_ssm, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def test_ssm_decode_step_matches_the_reference(model):
    """From a random f32 state and bf16 conv window: the output, the new
    state and window; the port's are updated in place."""
    rcfg, _, tcfg, _ = model
    r_ssm, t_ssm = _ssm_layer(model)
    cache = ssm.init_ssm_cache(tcfg, 2, 1, device="cpu")
    rng = np.random.default_rng(7)
    state = rng.standard_normal(cache["state"].shape[1:]).astype(np.float32)
    conv = rng.standard_normal(cache["conv"].shape[1:]).astype(np.float32)
    x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    y_r, st_r, cv_r = ref_ssm.ssm_decode_step(
        r_ssm, jnp.asarray(x), rcfg, jnp.asarray(state),
        jnp.asarray(conv, jnp.bfloat16))
    st_t = torch.from_numpy(state)
    cv_t = torch.from_numpy(conv).to(torch.bfloat16)
    with torch.no_grad():
        y_t, st2, cv2 = ssm.ssm_decode_step(t_ssm, torch.from_numpy(x), tcfg,
                                            st_t, cv_t)
    assert st2 is st_t and cv2 is cv_t
    for got, want in ((y_t, y_r), (st_t, st_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()))
    np.testing.assert_allclose(cv_t.float().numpy(),
                               np.asarray(cv_r, np.float32), rtol=BF16_STEP,
                               atol=1e-6)


def test_init_ssm_cache_is_the_references_layout(model):
    rcfg, _, tcfg, _ = model
    want = ref_ssm.init_ssm_cache(rcfg, 3, 2)
    got = ssm.init_ssm_cache(tcfg, 3, 2, device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
    assert got["state"].dtype == torch.float32
    assert got["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("window", [0, 8])
def test_decode_matches_forward(model, window):
    """The reference's test_decode_matches_forward_hybrid on the port (its
    window 0), and with a window of 8 over 32 tokens: decode applies the
    window to the cached keys and steps the SSM state in the same layer."""
    _, _, tcfg, tp = model
    cfg = tcfg.replace(sliding_window=window)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (1, 32)))
    full = api.forward(tp, toks, cfg)
    cache = api.init_cache(cfg, 1, 40, device="cpu")
    step = []
    for t in range(toks.shape[1]):
        lg, cache = api.decode_step(tp, toks[:, t:t + 1], cache, cfg)
        step.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(step, 1).numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    assert cache["pos"].tolist() == [32]
    assert float(cache["ssm"]["state"].abs().sum()) > 0


def test_window_changes_what_decode_sees(model):
    """The window is live on this path: past 8 tokens the windowed and the
    unwindowed decode part."""
    _, _, tcfg, tp = model
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (1, 12)))
    outs = {}
    for window in (0, 8):
        cfg = tcfg.replace(sliding_window=window)
        cache = api.init_cache(cfg, 1, 16, device="cpu")
        for t in range(12):
            lg, cache = api.decode_step(tp, toks[:, t:t + 1], cache, cfg)
            if t == 7:
                outs[window, "early"] = lg
        outs[window, "late"] = lg
    assert torch.equal(outs[0, "early"], outs[8, "early"])
    assert not torch.allclose(outs[0, "late"], outs[8, "late"])


def test_admit_keeps_the_previous_requests_state(model):
    """The reference's fault, kept as the spec (ROADMAP queue 1 item 10):
    ``admit`` resets only ``pos``, so a request admitted into a freed slot
    starts from the SSM state and conv window the last one left."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(9)
    first, second = (rng.integers(0, tcfg.vocab_size, (4,)) for _ in "ab")
    reused = ContinuousBatchingEngine(tcfg, tp, 1, 16)
    reused.run([first], 3)
    left = reused.cache["ssm"]["state"].clone()
    assert left.abs().sum() > 0
    reused.admit(second, 3)
    fresh = ContinuousBatchingEngine(tcfg, tp, 1, 16)
    fresh.admit(second, 3)
    assert reused.cache["pos"].tolist() == fresh.cache["pos"].tolist() == [4]
    assert not torch.allclose(reused.cache["ssm"]["state"],
                              fresh.cache["ssm"]["state"])
