"""PyTorch port, the dense LM serving path on the CPU, against the reference.

The reference's weights (``repro.models.api.init_params``) are carried
across with ``repro_torch.models.convert.params_from_jax``; tokens come from
``numpy.random.default_rng``.  Everything runs in float32 on the smoke
configs (2 layers, d_model 128) of smollm-135m, gemma2-2b with a sliding
window of 4 on alternating layers (softcaps, post norms, the sqrt(d_model)
embedding scale) and qwen2.5-14b (qkv bias, untied head).

Tolerances, each with its reason:

- ``forward`` at 1e-5: the same f32 arithmetic summed in another order
  (errors seen ~2e-6 on logits of magnitude ~2);
- decode logits at 1e-3 and the bf16 K/V cache at one bf16 step
  (2^-7 relative): the cache is bfloat16 in both packages, and an f32
  value within ~1e-6 of a bf16 rounding midpoint rounds either way
  (errors seen: one step in a few cache entries, ~2e-4 on logits);
- decode against forward at the reference's own 2e-2
  (``tests/test_arch_smoke.py::test_decode_matches_forward_dense``);
- the serving engines' tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_arch as ref_arch
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.train.step import make_decode_step as ref_decode_step
from repro.train.step import make_prefill_step as ref_prefill_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import _cuda
from repro_torch.models import api, common, lm
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
from repro_torch.train.step import make_decode_step, make_prefill_step

FWD_TOL = 1e-5
DECODE_TOL = 1e-3
BF16_STEP = 2.0 ** -7
CONSISTENCY_TOL = 2e-2

CASES = {
    "smollm-135m": {},
    "gemma2-2b": dict(sliding_window=4, local_global_pattern=True),
    "qwen2.5-14b": {},
}


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    """(reference cfg, reference params, port cfg, port params)."""
    name = request.param
    rcfg = ref_arch(name).smoke().replace(**CASES[name])
    tcfg = get_arch(name).smoke().replace(**CASES[name])
    rp = ref_api.init_params(jax.random.PRNGKey(len(name)), rcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rcfg, rp, tcfg, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_configs_are_the_references(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    assert port.resolved_head_dim == ref.resolved_head_dim
    # the reference applies sqrt(d_model) to gemma's embeddings (lm.py:195)
    assert port.embed_scale == (ref.d_model ** 0.5
                                if ref.name.startswith("gemma") else 1.0)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_layer_windows_are_the_references(name):
    cfg = get_arch(name).replace(sliding_window=8) \
        if name.startswith("gemma") else get_arch(name)
    rcfg = ref_arch(name).replace(sliding_window=cfg.sliding_window)
    assert lm.layer_windows(cfg) == \
        np.asarray(ref_lm.layer_windows(rcfg)).tolist()
    assert all(isinstance(w, int) for w in lm.layer_windows(cfg))


# ------------------------------------------------------------------- common
def test_common_numerics_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32) * 0.1
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    for dt in ("float32", "bfloat16"):
        jx, tx = jnp.asarray(x).astype(dt), torch.from_numpy(x).to(
            common.dtype_of(dt))
        tol = 1e-6 if dt == "float32" else BF16_STEP
        pairs = [
            (ref_common.rms_norm(jx, jnp.asarray(g)),
             common.rms_norm(tx, torch.from_numpy(g))),
            (ref_common.apply_rope(jx, jnp.asarray(pos), 10_000.0),
             common.apply_rope(tx, torch.from_numpy(pos), 10_000.0)),
            (ref_common.softcap(jx, 2.0), common.softcap(tx, 2.0)),
            (ref_common.silu(jx), common.silu(tx)),
            (ref_common.gelu(jx), common.gelu(tx)),
        ]
        for want, got in pairs:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
    qp, kp = np.arange(7)[:, None].repeat(1, 1)[:, 0], np.arange(7)
    for w in (0, 3):
        assert np.array_equal(
            common.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                               w).numpy(),
            np.asarray(ref_common.causal_mask(jnp.asarray(qp),
                                              jnp.asarray(kp), w)))
    for v in (512, 49152, 49155, 151655):
        assert common.padded_vocab(v) == ref_common.padded_vocab(v)
    lg = rng.standard_normal((2, 300)).astype(np.float32)
    np.testing.assert_array_equal(
        common.mask_vocab_pad(torch.from_numpy(lg), 290).numpy(),
        np.asarray(ref_common.mask_vocab_pad(jnp.asarray(lg), 290)))


# -------------------------------------------------------------- parameters
def test_params_carry_across_and_init_has_the_references_shapes(model):
    rcfg, rp, tcfg, tp = model
    ref_tree = jax.tree.map(np.asarray, rp)
    n_ref = sum(a.size for a in jax.tree.leaves(ref_tree))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    np.testing.assert_array_equal(tp.embed.detach().numpy(),
                                  ref_tree["embed"])
    np.testing.assert_array_equal(tp.layers[1].attn.wq.detach().numpy(),
                                  ref_tree["layers"]["attn"]["wq"][1])
    fresh = api.init_params(7, tcfg, device="cpu")
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tp.named_parameters()}
    again = api.init_params(torch.Generator().manual_seed(7), tcfg,
                            device="cpu")
    for a, b in zip(fresh.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in fresh.parameters())


# ------------------------------------------------------------------ forward
def test_forward_matches_the_reference(model):
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 12))
    got = api.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    want = np.asarray(ref_api.forward(rp, jnp.asarray(toks), rcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_forward_matches_the_references_kernel_path(model):
    """The reference's Pallas path (interpret mode).  It runs only
    unrolled and un-jitted: under ``scan_layers`` its ``int(window)`` meets
    a traced per-layer scalar (ROADMAP queue 1 item 10)."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (1, 16), seed=1)
    kcfg = rcfg.replace(use_pallas=True, scan_layers=False)
    want = np.asarray(ref_lm.forward(rp, jnp.asarray(toks), kcfg))
    got = api.forward(tp, torch.from_numpy(toks),
                      tcfg.replace(use_pallas=True)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


# ------------------------------------------------------------------- decode
def test_decode_step_matches_the_reference_step_by_step(model):
    """Each step starts from the reference's cache (``cache_from_jax``), so
    one step's differences do not carry into the next."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 6), seed=2)
    rc = ref_api.init_cache(rcfg, 2, 8)
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        tc = cache_from_jax(jax.tree.map(np.asarray, rc), device="cpu")
        assert tc["k"].dtype == torch.bfloat16
        lg_t, tc = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, tcfg)
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        want, got = _f32(rc), cache_to_numpy(tc)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for kv in ("k", "v"):
            np.testing.assert_allclose(got[kv], want[kv], rtol=BF16_STEP,
                                       atol=1e-6)


def test_decode_matches_forward(model):
    """The reference's test_decode_matches_forward_dense / _sliding_window
    on the port: teacher-forced forward logits against decode logits."""
    _, _, tcfg, tp = model
    toks = torch.from_numpy(_tokens(tcfg, (1, 12), seed=3))
    full = api.forward(tp, toks, tcfg)
    cache = api.init_cache(tcfg, 1, 16, device="cpu")
    step = []
    for t in range(toks.shape[1]):
        lg, cache = api.decode_step(tp, toks[:, t:t + 1], cache, tcfg)
        step.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(step, 1).numpy(),
                               rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)
    assert cache["pos"].tolist() == [12]


def test_decode_past_max_len_clamps_like_the_reference(model):
    """Past ``max_len`` the reference's dynamic_update_slice writes the last
    row; the continuous-batching engine's idle slots reach it."""
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (1, 6), seed=4)
    rc = ref_api.init_cache(rcfg, 1, 4)
    tc = api.init_cache(tcfg, 1, 4, device="cpu")
    ref_step = jax.jit(lambda p, t, c: ref_api.decode_step(p, t, c, rcfg))
    for t in range(toks.shape[1]):
        lg_t, tc = api.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                   tc, tcfg)
        lg_r, rc = ref_step(rp, jnp.asarray(toks[:, t:t + 1]), rc)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(cache_to_numpy(tc)["k"], _f32(rc)["k"],
                               rtol=BF16_STEP, atol=1e-6)


# ------------------------------------------------------------- serve steps
def test_prefill_and_decode_steps_match_the_reference(model):
    rcfg, rp, tcfg, tp = model
    toks = _tokens(rcfg, (2, 9), seed=5)
    got = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    want = jax.jit(ref_prefill_step(rcfg))(rp, {"tokens": jnp.asarray(toks)})
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
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
    """``jax.numpy`` whose ``asarray`` takes a private copy of a numpy
    input.  The reference's engine hands ``jnp.asarray(self.slot_tokens)``
    to an asynchronously dispatched step and then writes ``slot_tokens``
    again; on the CPU ``asarray`` may share the numpy buffer (when it is
    aligned), and the step then reads the next token instead: the
    reference's ``admit`` gave another token than its own ``prefill`` in
    some runs and not in others.  A copy nobody writes makes it
    deterministic; it changes nothing else."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(np.array(a, copy=True), *args, **kw)


@pytest.fixture
def ref_engines(monkeypatch):
    monkeypatch.setattr(ref_engine, "jnp", _CopyingJnp())
    return ref_engine


def test_serve_engine_tokens_match_the_reference(model, ref_engines):
    rcfg, rp, tcfg, tp = model
    prompts = _tokens(rcfg, (3, 5), seed=6)
    want = ref_engines.ServeEngine(rcfg, rp, 3, 32).generate(prompts, 8)
    got = ServeEngine(tcfg, tp, 3, 32).generate(prompts, 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_continuous_batching_tokens_match_the_reference(model, ref_engines):
    """Five requests over two slots; max_len 16 is small enough that the
    admission steps push idle slots past it (the reference's quirk)."""
    rcfg, rp, tcfg, tp = model
    rng = np.random.default_rng(7)
    requests = [rng.integers(0, rcfg.vocab_size, (4,)) for _ in range(5)]
    want = ref_engines.ContinuousBatchingEngine(rcfg, rp, 2, 16).run(
        requests, 5)
    eng = ContinuousBatchingEngine(tcfg, tp, 2, 16)
    got = eng.run(requests, 5)
    assert got == want
    assert len(got) == 5 and all(len(toks) == 5 for _, toks in got)
    assert eng.cache["pos"].max().item() > 16


def test_continuous_batching_reuses_slots():
    cfg = get_arch("smollm-135m").smoke()
    params = api.init_params(0, cfg, device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, batch=1, max_len=32)
    rng = np.random.default_rng(2)
    done = eng.run([rng.integers(0, cfg.vocab_size, (2,)) for _ in range(3)],
                   gen_len=3)
    assert [s for s, _ in done] == [0, 0, 0]
    assert not eng.admit(np.array([1]), 1) or eng.active.sum() == 1


# -------------------------------------------------------- what is not ported
@pytest.mark.parametrize("name", sorted(
    n for n, c in ARCHS.items() if c.family in ("moe", "hybrid", "vlm",
                                                 "audio")))
def test_families_not_ported_raise(name):
    """The last families (moe, hybrid, vlm, audio) are ported: they build
    and take a cache.  A family the port does not know still raises."""
    cfg = get_arch(name).smoke()
    assert sum(p.numel() for p in api.init_params(
        0, cfg, device="cpu").parameters()) > 0
    assert api.init_cache(cfg, 1, 8, device="cpu")["pos"].tolist() == [0]
    unknown = cfg.replace(family="retnet")
    with pytest.raises(NotImplementedError, match="not a decoder-only"):
        api.init_params(0, unknown, device="cpu")
    with pytest.raises(NotImplementedError, match="'retnet'"):
        api.init_cache(unknown, 1, 8, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    cfg = get_arch("smollm-135m").smoke()
    for call in (lambda: api.init_params(0, cfg),
                 lambda: api.init_cache(cfg, 1, 8),
                 lambda: params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--smoke"])


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    before = _cuda.FLASH.launches
    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "3",
                "--max-len", "8"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "on cpu" in out
    assert _cuda.FLASH.launches == before
