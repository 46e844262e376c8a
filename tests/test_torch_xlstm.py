"""PyTorch port, xlstm-1.3b serving (``family="ssm"``) on the CPU, against
the reference.

The reference's weights (``repro.models.api.init_params``) are carried
across with ``repro_torch.models.convert.params_from_jax``; tokens and
kernel inputs come from ``numpy.random.default_rng``.  Everything runs in
float32 on two smoke configs: ``xlstm-1.3b`` ``.smoke()`` (2 layers: one
supergroup of one mLSTM and one sLSTM block; d_model 128, 4 heads, P 64,
Pv 65, chunk 16) and a deeper one (6 layers, ``slstm_every`` 3: two
supergroups of two mLSTM blocks, so the ``[G, M, ...]`` stacks unstack
for real).

Tolerances, each with its reason:

- ``forward`` and each block at 1e-5: the same f32 arithmetic summed in
  another order (errors seen ~5e-7 on logits of magnitude ~1);
- decode logits and the f32 recurrent states at 1e-5 (seen ~4e-7), step
  by step from the reference's own cache;
- the bf16 conv window at one bf16 step (2^-7 relative): an f32 value
  within ~1e-7 of a bf16 rounding midpoint rounds either way (seen: one
  step in a few entries);
- decode against forward at the reference's own 3e-2
  (``tests/test_arch_smoke.py::test_decode_matches_forward_ssm``): decode
  rounds the conv window through bf16, the forward does not;
- the serving engines' tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro.train.step import make_decode_step as ref_decode_step
from repro.train.step import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_arch
from repro_torch.kernels import _cuda
from repro_torch.models import api, lm, ssm, xlstm
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.train.step import make_decode_step, make_prefill_step

TOL = 1e-5
BF16_STEP = 2.0 ** -7
CONSISTENCY_TOL = 3e-2

CASES = {"smoke": {}, "deep": dict(num_layers=6, slstm_every=3)}


def _cfgs(case):
    """(reference cfg, port cfg) of one case."""
    kw = dict(CASES[case])
    every = kw.pop("slstm_every", None)
    out = []
    for get in (ref_arch, get_arch):
        cfg = get("xlstm-1.3b").smoke().replace(**kw)
        if every:
            cfg = cfg.replace(xlstm=dataclasses.replace(cfg.xlstm,
                                                        slstm_every=every))
        out.append(cfg)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    """(reference cfg, reference params, port cfg, port params)."""
    rcfg, tcfg = _cfgs(request.param)
    rp = ref_api.init_params(jax.random.PRNGKey(3), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# -------------------------------------------------------------- parameters
def test_params_carry_across_and_init_has_the_references_shapes(model):
    rcfg, rp, tcfg, tp = model
    tree = jax.tree.map(np.asarray, rp)
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    G, M = lm.xlstm_groups(tcfg)
    assert tree["mlstm"]["w_q"].shape[:2] == (G, M)
    assert len(tp.groups) == G and len(tp.groups[0].mlstm) == M
    np.testing.assert_array_equal(tp.groups[G - 1].mlstm[M - 1].w_q.detach().numpy(),
                                  tree["mlstm"]["w_q"][G - 1, M - 1])
    np.testing.assert_array_equal(
        tp.groups[G - 1].slstm.r_gates.detach().numpy(),
                                  tree["slstm"]["r_gates"][G - 1])
    np.testing.assert_array_equal(tp.groups[G - 1].ln_m.detach().numpy(),
                                  tree["ln_m"][G - 1])
    assert "lm_head" not in tree and not hasattr(tp, "lm_head")   # tied
    fresh = api.init_params(7, tcfg, device="cpu")
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tp.named_parameters()}
    again = api.init_params(torch.Generator().manual_seed(7), tcfg,
                            device="cpu")
    for a, b in zip(fresh.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in fresh.parameters())


def test_full_width_parameter_count_is_the_references():
    """xlstm-1.3b at its published widths: with the reference's full
    d_inner x d_inner ``w_q`` / ``w_k`` the model has ~2.72e9 parameters,
    not 1.3e9 (counted on the meta device: nothing is allocated)."""
    cfg = get_arch("xlstm-1.3b")
    n_port = sum(p.numel() for p in lm.LM(cfg, device="meta").parameters())
    shapes = jax.eval_shape(lambda k: ref_api.init_params(k, ref_arch(
        "xlstm-1.3b")), jax.random.PRNGKey(0))
    assert n_port == sum(int(np.prod(s.shape))
                         for s in jax.tree.leaves(shapes))
    assert 2.70e9 < n_port < 2.74e9
    assert xlstm.mlstm_dims(cfg) == (4096, 4, 1024) and cfg.head_dim == 512


# ------------------------------------------------------------------ blocks
def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    _close(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w)), 1e-6)


def test_blocks_match_the_reference(model):
    """One mLSTM and one sLSTM block alone, on the same input: the mLSTM
    through the kernel lane (under no_grad, as serving runs it) and
    through the training lane (``_ssd_scan_perhead`` under autograd)."""
    rcfg, rp, tcfg, tp = model
    x = np.random.default_rng(1).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    tree = jax.tree.map(np.asarray, rp)
    r_m = jax.tree.map(lambda a: jnp.asarray(a[0, 0]), tree["mlstm"])
    r_s = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["slstm"])
    want = ref_xlstm.mlstm_forward(r_m, jnp.asarray(x), rcfg)
    with torch.no_grad():
        _close(xlstm.mlstm_forward(tp.groups[0].mlstm[0],
                                   torch.from_numpy(x), tcfg), want)
    got = xlstm.mlstm_forward(tp.groups[0].mlstm[0], torch.from_numpy(x),
                              tcfg, lane="train")
    assert got.requires_grad
    _close(got.detach(), want)
    _close(xlstm.slstm_forward(tp.groups[0].slstm, torch.from_numpy(x),
                               tcfg).detach(),
           ref_xlstm.slstm_forward(r_s, jnp.asarray(x), rcfg))


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("S", [12, 32])
def test_forward_matches_the_reference(model, S):
    """Against both reference paths: XLA (``use_pallas=False``,
    ``_ssd_scan_perhead`` under ``lax.scan``) and its Pallas kernel in
    interpret mode (``use_pallas=True``, unrolled).  S 12 is one chunk of
    12 rows, S 32 two chunks of 16."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, S), seed=S)
    got = api.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    for rc in (rcfg, rcfg.replace(use_pallas=True, scan_layers=False)):
        want = np.asarray(ref_lm.forward(rp, jnp.asarray(toks), rc))
        assert got.shape == want.shape
        _close(got, want)


def test_forward_ignores_use_pallas(model):
    _, _, tcfg, tp = model
    toks = torch.from_numpy(_tokens(tcfg, (1, 16), seed=4))
    assert torch.equal(api.forward(tp, toks, tcfg),
                       api.forward(tp, toks, tcfg.replace(use_pallas=True)))


# ------------------------------------------------------------------- decode
def test_decode_step_matches_the_reference_step_by_step(model):
    """Each step starts from the reference's cache (``cache_from_jax``), so
    one step's differences do not carry into the next; every part of the
    nested cache comes back (``cache_to_numpy``)."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 6), seed=2)
    rc = ref_api.init_cache(rcfg, 2, 8)
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        tc = cache_from_jax(jax.tree.map(np.asarray, rc), device="cpu")
        assert tc["mlstm"]["conv"].dtype == torch.bfloat16
        assert tc["mlstm"]["state"].dtype == torch.float32
        lg_t, tc2 = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tc, tcfg)
        assert tc2 is tc
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        _close(lg_t, lg_r)
        want, got = _f32(rc), cache_to_numpy(tc)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        _close(got["mlstm"]["state"], want["mlstm"]["state"])
        np.testing.assert_allclose(got["mlstm"]["conv"],
                                   want["mlstm"]["conv"], rtol=BF16_STEP,
                                   atol=1e-6)
        for name in ("h", "c", "n"):
            _close(got["slstm"][name], want["slstm"][name])


def test_init_cache_matches_the_references_layout(model):
    rcfg, _, tcfg, _ = model
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        ref_api.init_cache(rcfg, 3, 8))
    got = cache_to_numpy(api.init_cache(tcfg, 3, 8, device="cpu"))
    assert jax.tree.map(lambda a: a.shape, got) == \
        jax.tree.map(lambda sd: sd[0], want, is_leaf=lambda x:
                     isinstance(x, tuple))
    tc = api.init_cache(tcfg, 3, 8, device="cpu")
    assert tc["mlstm"]["conv"].dtype == torch.bfloat16
    assert tc["pos"].dtype == torch.int32
    # h, c and n are written in place: they must not share storage
    ptrs = {tc["slstm"][n].data_ptr() for n in ("h", "c", "n")}
    assert len(ptrs) == 3


def test_decode_matches_forward(model):
    """The reference's test_decode_matches_forward_ssm on the port."""
    _, _, tcfg, tp = model
    toks = torch.from_numpy(_tokens(tcfg, (1, 8), seed=8))
    full = api.forward(tp, toks, tcfg)
    cache = api.init_cache(tcfg, 1, 16, device="cpu")
    step = []
    for t in range(toks.shape[1]):
        lg, cache = api.decode_step(tp, toks[:, t:t + 1], cache, tcfg)
        step.append(lg[:, 0])
    _close(full, torch.stack(step, 1), CONSISTENCY_TOL)
    assert cache["pos"].tolist() == [8]


# ------------------------------------------------------------- serve steps
def test_prefill_and_decode_steps_match_the_reference(model):
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 9), seed=5)
    got = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    want = jax.jit(ref_prefill_step(rcfg))(rp, {"tokens": jnp.asarray(toks)})
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    tc = api.init_cache(tcfg, 2, 12, device="cpu")
    rc = ref_api.init_cache(rcfg, 2, 12)
    t_tok, r_tok = torch.from_numpy(toks[:, :1]), jnp.asarray(toks[:, :1])
    t_step, r_step = make_decode_step(tcfg), jax.jit(ref_decode_step(rcfg))
    for _ in range(6):
        t_tok, tc = t_step(tp, t_tok, tc)
        r_tok, rc = r_step(rp, r_tok, rc)
        assert t_tok.dtype == torch.int32 and tuple(t_tok.shape) == (2, 1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))


# ------------------------------------------------------------------ engines
class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy input: the reference's
    engine hands ``jnp.asarray(self.slot_tokens)`` to an asynchronous step
    and then writes ``slot_tokens`` (see ``tests/test_torch_lm.py``)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(np.array(a, copy=True), *args, **kw)


class _SeparateBuffersApi:
    """The reference's ``models.api`` whose ``init_cache`` gives every leaf
    its own buffer.  The reference's ``init_slstm_cache`` returns one zeros
    array as ``h``, ``c`` and ``n`` (``models/xlstm.py:223-227``), and its
    engines jit the decode step with the cache donated, so their first step
    fails ("Attempt to donate the same buffer twice"): as it stands the
    reference cannot serve xlstm from its engines (ROADMAP queue 1 item
    10).  Copies of zeros change no value."""

    def __getattr__(self, name):
        return getattr(ref_api, name)

    @staticmethod
    def init_cache(*args, **kw):
        return jax.tree.map(jnp.copy, ref_api.init_cache(*args, **kw))


@pytest.fixture
def ref_engines(monkeypatch):
    monkeypatch.setattr(ref_engine, "jnp", _CopyingJnp())
    monkeypatch.setattr(ref_engine, "api", _SeparateBuffersApi())
    return ref_engine


def test_reference_engine_cannot_serve_xlstm_as_it_stands(model):
    """What ``_SeparateBuffersApi`` works around; the port's cache has
    separate ``h``, ``c``, ``n`` (``test_init_cache_matches_the_references
    _layout``) and serves."""
    rcfg, rp, tcfg, tp = model
    prompts = _tokens(rcfg, (1, 2), seed=6)
    with pytest.raises(Exception, match="donate the same buffer"):
        ref_engine.ServeEngine(rcfg, rp, 1, 8).generate(prompts, 2)
    assert ServeEngine(tcfg, tp, 1, 8).generate(prompts, 2).shape == (1, 2)


def test_serve_engine_tokens_match_the_reference(model, ref_engines):
    rcfg, rp, tcfg, tp = model
    prompts = _tokens(rcfg, (3, 5), seed=6)
    want = ref_engines.ServeEngine(rcfg, rp, 3, 32).generate(prompts, 8)
    got = ServeEngine(tcfg, tp, 3, 32).generate(prompts, 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_continuous_batching_tokens_match_the_reference(model, ref_engines):
    """Five requests over two slots, so three are admitted into a slot a
    finished request left: tokens identical to the reference's, whose
    ``admit`` resets only ``pos`` and keeps the slot's recurrent state."""
    rcfg, rp, tcfg, tp = model
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, rcfg.vocab_size, (4,)) for _ in range(5)]
    want = ref_engines.ContinuousBatchingEngine(rcfg, rp, 2, 16).run(
        requests, 5)
    got = ContinuousBatchingEngine(tcfg, tp, 2, 16).run(requests, 5)
    assert got == want
    assert len(got) == 5 and all(len(toks) == 5 for _, toks in got)
    assert sorted(s for s, _ in got).count(0) >= 2


def test_admit_keeps_the_previous_requests_state(model):
    """The reference's fault, kept as the spec (ROADMAP queue 1 item 10):
    a request admitted into a freed slot starts from the state the last
    one left, so it is served differently from the same request in a
    fresh engine."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(9)
    first, second = (rng.integers(0, tcfg.vocab_size, (4,)) for _ in "ab")
    reused = ContinuousBatchingEngine(tcfg, tp, 1, 16)
    reused.run([first], 3)
    left = reused.cache["mlstm"]["state"].clone()
    assert left.abs().sum() > 0
    reused.admit(second, 3)
    fresh = ContinuousBatchingEngine(tcfg, tp, 1, 16)
    fresh.admit(second, 3)
    assert reused.cache["pos"].tolist() == fresh.cache["pos"].tolist() == [4]
    assert not torch.allclose(reused.cache["mlstm"]["state"],
                              fresh.cache["mlstm"]["state"])


# ------------------------------------------------------------ entry points
def test_init_defaults_to_the_card():
    """``lm.init_params`` / ``lm.init_cache`` and the xlstm cache inits
    default to ``device="cuda"`` (through ``resolve_device``), as
    ``api`` does: without a card they raise instead of handing out CPU
    tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    cfg = get_arch("xlstm-1.3b").smoke()
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: lm.init_params(gen, cfg),
                 lambda: lm.init_cache(cfg, 1, 8),
                 lambda: lm.init_params(gen, get_arch("smollm-135m").smoke()),
                 lambda: xlstm.init_mlstm_cache(cfg, 1, 1),
                 lambda: xlstm.init_slstm_cache(cfg, 1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert lm.init_params(gen, cfg, device="cpu").device.type == "cpu"
    assert lm.init_cache(cfg, 1, 8, device="cpu")["pos"].device.type == "cpu"


def test_launcher_serves_xlstm_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    before = _cuda.MLSTM.launches
    serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "32", "--gen-len", "3",
                "--max-len", "8"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "on cpu" in out
    assert _cuda.MLSTM.launches == before
