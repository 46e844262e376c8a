"""PyTorch port, the MoE layer (``models/moe.py``) on the CPU, against the
reference.

The reference's ``init_moe`` weights cross over through the model's
layer 0 (``params_from_jax``: the stacked experts [E, d, f] stay whole);
inputs come from ``numpy.random.default_rng``.  Configs: granite-moe-3b-
a800m and qwen3-moe-30b-a3b at ``.smoke()`` (d_model 128, 8 experts
padded to 16, top-2, d_expert 64), float32, and the same with 2 shared
experts (``num_shared_experts``, which no published config here uses).

At depth: every layer's MoE input in a 4-layer smoke model on 2 x 128
seeded tokens routes to the same experts, so the experts' loads (and
the choices a capacity drops) are the reference's.

Tolerances: routes (indices) identical; routing weights and
``moe_dense`` at 1e-5 (the same f32 arithmetic summed in another order).
A tie between the k-th and the (k+1)-th logit would let the two
frameworks pick different experts; none occurs on these inputs (the
gaps are checked and printed in the failure message if one did).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax

TOL = 1e-5

CASES = {
    "granite-moe-3b-a800m": {},
    "qwen3-moe-30b-a3b": {},
    "qwen3-moe-30b-a3b shared": dict(num_shared_experts=2, d_shared=48),
}


def _cfgs(case):
    name = case.split()[0]
    r, t = ref_arch(name).smoke(), get_arch(name).smoke()
    if CASES[case]:
        r = r.replace(moe=dataclasses.replace(r.moe, **CASES[case]))
        t = t.replace(moe=dataclasses.replace(t.moe, **CASES[case]))
    return r, t


@pytest.fixture(scope="module", params=list(CASES))
def layer(request):
    """(reference cfg, reference MoE params, port cfg, port MoE)."""
    rcfg, tcfg = _cfgs(request.param)
    rp = ref_api.init_params(jax.random.PRNGKey(3), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    r_moe = jax.tree.map(lambda a: a[0], rp["layers"]["moe"])
    return rcfg, r_moe, tcfg, tp.layers[0].moe


def _x(cfg, shape=(2, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def test_padded_experts_are_the_references():
    for name in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b"):
        r, t = ref_arch(name), get_arch(name)
        for rc, tc in ((r, t), (r.smoke(), t.smoke())):
            assert moe.padded_experts(tc.moe) == \
                ref_moe.padded_experts(rc.moe)
    assert moe.padded_experts(get_arch("granite-moe-3b-a800m").moe) == 48
    assert moe.padded_experts(get_arch("granite-moe-3b-a800m").smoke()
                              .moe) == 16


def test_layout_is_the_references(layer):
    rcfg, r_moe, tcfg, t_moe = layer
    got = {n: tuple(p.shape) for n, p in t_moe.named_parameters()}
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"):
            tuple(a.shape) for k, a in
            jax.tree_util.tree_flatten_with_path(r_moe)[0]}
    assert got == want
    assert got["router"] == (tcfg.d_model, 16)
    assert got["w_gate"] == (16, tcfg.d_model, tcfg.moe.d_expert)


def test_route_matches_the_reference(layer):
    rcfg, r_moe, tcfg, t_moe = layer
    x = _x(rcfg)
    rw, ri = ref_moe._route(r_moe, jnp.asarray(x), rcfg.moe)
    with torch.no_grad():
        tw, ti = moe._route(t_moe, torch.from_numpy(x), tcfg.moe)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    router = np.asarray(r_moe["router"])[:, :rcfg.moe.num_experts]
    logits = np.sort(x @ router, axis=-1)[..., ::-1]
    k = rcfg.moe.top_k
    gap = float((logits[..., k - 1] - logits[..., k]).min())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri),
                                  err_msg=f"smallest k-th gap {gap:.3g}")
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_padded_experts_are_never_chosen(layer):
    """Even when the router's padding columns would win by far, their
    -1e30 logits keep them out of the top k."""
    rcfg, r_moe, tcfg, t_moe = layer
    E, n = t_moe.router.shape[-1], tcfg.moe.num_experts
    assert E > n
    x = np.abs(_x(tcfg, seed=1))
    with torch.no_grad():
        t_moe.router[:, n:] += 100.0
    try:
        _, ti = moe._route(t_moe, torch.from_numpy(x), tcfg.moe)
    finally:
        with torch.no_grad():
            t_moe.router[:, n:] -= 100.0
    assert int(ti.max()) < n
    assert ti.shape[-1] == tcfg.moe.top_k
    # k distinct experts per token
    assert all(len(set(r)) == tcfg.moe.top_k
               for r in ti.reshape(-1, tcfg.moe.top_k).tolist())


def test_moe_dense_matches_the_reference(layer):
    rcfg, r_moe, tcfg, t_moe = layer
    x = _x(rcfg, seed=2)
    want = np.asarray(ref_moe.moe_dense(r_moe, jnp.asarray(x), rcfg))
    with torch.no_grad():
        got = moe.moe_dense(t_moe, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_moe_serves_every_impl_through_moe_dense(layer, impl):
    """With no mesh the reference's ``moe`` takes ``moe_dense`` for both
    ``impl`` values, and so does the port's."""
    rcfg, r_moe, tcfg, t_moe = layer
    rc = rcfg.replace(moe=dataclasses.replace(rcfg.moe, impl=impl))
    tc = tcfg.replace(moe=dataclasses.replace(tcfg.moe, impl=impl))
    x = _x(rcfg, seed=3)
    want = np.asarray(ref_moe.moe(r_moe, jnp.asarray(x), rc, mesh=None))
    with torch.no_grad():
        got = moe.moe(t_moe, torch.from_numpy(x), tc)
        assert torch.equal(got, moe.moe_dense(t_moe, torch.from_numpy(x),
                                              tc))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_moe_routing_actually_sparse():
    """The reference's test on the port: only the top-k experts may
    contribute, so zeroing the unused experts' weights changes nothing."""
    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    p = moe.MoE(cfg).reset_parameters(torch.Generator().manual_seed(11))
    x = torch.from_numpy(_x(cfg, (1, 4), seed=12))
    with torch.no_grad():
        _, idx = moe._route(p, x, cfg.moe)
        used = torch.unique(idx.long())
        out = moe.moe_dense(p, x, cfg)
        keep = torch.zeros(p.router.shape[-1], dtype=torch.bool)
        keep[used] = True
        for w in (p.w_gate, p.w_up, p.w_down):
            w.mul_(keep[:, None, None])
        out2 = moe.moe_dense(p, x, cfg)
    assert len(used) < cfg.moe.num_experts
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_moe_dense_grads_match_the_reference(layer):
    """Under autograd (the train lane runs it), the weights' grads of a
    scalar of the output."""
    rcfg, r_moe, tcfg, t_moe = layer
    x = _x(rcfg, seed=4)
    proj = np.random.default_rng(5).standard_normal(
        (rcfg.d_model,)).astype(np.float32)
    want = jax.grad(lambda p: (ref_moe.moe_dense(p, jnp.asarray(x), rcfg)
                               @ jnp.asarray(proj)).sum())(r_moe)
    out = moe.moe_dense(t_moe, torch.from_numpy(x), tcfg)
    named = dict(t_moe.named_parameters())
    grads = torch.autograd.grad((out @ torch.from_numpy(proj)).sum(),
                                list(named.values()))
    for (name, _), g in zip(named.items(), grads):
        w = want
        for part in name.split("."):
            w = w[part]
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_loads_at_depth_are_the_references(name, monkeypatch):
    """Each layer's MoE input in the whole model's forward (the reference
    unrolled, ``scan_layers=False``, so its inputs can be recorded) gives
    the reference's routes, and so its experts' loads: how unevenly
    tokens spread over the experts at depth, and what a capacity drops,
    is the model's, not the port's."""
    from repro.models import lm as ref_lm
    from repro_torch.models import lm

    rcfg = ref_arch(name).smoke().replace(num_layers=4, scan_layers=False)
    tcfg = get_arch(name).smoke().replace(num_layers=4)
    rp = ref_api.init_params(jax.random.PRNGKey(5), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (2, 128))
    seen = {"ref": [], "port": []}
    ref_moe_apply, port_moe = ref_lm.moe_apply, lm.moe

    def ref_rec(p, h, cfg, mesh=None):
        seen["ref"].append(np.asarray(ref_moe._route(p, h, cfg.moe)[1]))
        return ref_moe_apply(p, h, cfg, mesh=mesh)

    def port_rec(p, h, cfg, mesh=None):
        seen["port"].append(moe._route(p, h, cfg.moe)[1].numpy())
        return port_moe(p, h, cfg, mesh=mesh)

    monkeypatch.setattr(ref_lm, "moe_apply", ref_rec)
    monkeypatch.setattr(lm, "moe", port_rec)
    ref_lm.hidden_forward(rp, jnp.asarray(toks), rcfg)
    with torch.no_grad():
        lm.hidden_forward(tp, torch.from_numpy(toks), tcfg)
    assert len(seen["ref"]) == len(seen["port"]) == 4
    E = moe.padded_experts(tcfg.moe)
    for i, (r, t) in enumerate(zip(seen["ref"], seen["port"])):
        np.testing.assert_array_equal(
            np.bincount(t.ravel(), minlength=E),
            np.bincount(r.ravel(), minlength=E), err_msg=f"layer {i}")
        np.testing.assert_array_equal(t, r, err_msg=f"layer {i}")
