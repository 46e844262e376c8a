"""PyTorch port, the fault-tolerance substrate: the cases of
``tests/test_fault_tolerance.py`` on ``repro_torch`` (checkpoint round trip,
latest and gc, atomicity, resume equivalence, ``best_mesh_shape``, the
straggler monitor, data resume and host sharding, compression), each also
held against the reference where the reference computes the same thing.

The data stream must equal the reference's bit for bit; checkpoints round
trip exactly (dtypes kept: float32, bfloat16, int32); the resume
equivalence and the compression bound are the reference's own
(``rtol`` 1e-6, 2 % error feedback).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticTokenStream as RefStream
from repro.distrib.elastic import StragglerMonitor as RefMonitor
from repro.distrib.elastic import best_mesh_shape as ref_best_mesh_shape
from repro.optim.compression import compress as ref_compress
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
from repro_torch.distrib.checkpoint import CheckpointManager
from repro_torch.distrib.elastic import StragglerMonitor, best_mesh_shape
from repro_torch.optim.adamw import AdamWState, adamw_update, init_adamw
from repro_torch.optim.compression import compress, decompress, \
    init_residuals


# ------------------------------------------------------------- checkpointing
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = _tree()
    opt = init_adamw(params)
    mgr.save(10, params, opt, extra={"data": {"step": 10, "seed": 0,
                                              "host_id": 0}})
    p2, o2, extra = mgr.restore(10, params, opt)
    for a, b in zip(_leaves(params), _leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert extra["data"]["step"] == 10
    assert isinstance(o2, AdamWState) and int(o2.step) == int(opt.step)
    assert o2.step.dtype == torch.int32


def test_checkpoint_roundtrip_of_a_model_and_its_optimizer(tmp_path):
    """A module template gets the values copied into its parameters."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    cfg = get_arch("smollm-135m").smoke()
    params = api.init_params(1, cfg, device="cpu")
    opt = init_adamw(params)
    opt = opt._replace(step=opt.step + 7,
                       mu={k: v + 0.5 for k, v in opt.mu.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, opt, extra={"data": {"step": 3}})
    fresh = api.init_params(2, cfg, device="cpu")
    p2, o2, _ = mgr.restore(3, fresh, init_adamw(fresh))
    assert p2 is fresh
    for (n, a), (_, b) in zip(params.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
    assert int(o2.step) == 7
    assert all(torch.equal(o2.mu[k], opt.mu[k]) for k in opt.mu)


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, params)
    assert mgr.latest() == 4
    assert mgr.all_steps() == [3, 4]          # keep=2 garbage-collected


def test_checkpoint_atomicity(tmp_path):
    """A crashed save (leftover .tmp dir) must be invisible to latest()."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_000000000009.tmp"))
    assert mgr.latest() == 5                  # tmp dir ignored
    mgr.save(9, _tree())                      # overwrite stale tmp, publish
    assert mgr.latest() == 9
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "step_000000000009.tmp"))


def test_training_resume_equivalence(tmp_path):
    """Train 4 steps straight vs 2 + checkpoint + restore + 2: identical."""
    params = {"w": torch.ones(4, 4) * 0.5}
    opt = init_adamw(params)

    def step(p, o, i):
        g = {"w": torch.full((4, 4), 0.1 * (i + 1))}
        return adamw_update(g, o, p, lr=1e-2)

    p1, o1 = params, opt
    for i in range(4):
        p1, o1 = step(p1, o1, i)

    p2, o2 = params, opt
    for i in range(2):
        p2, o2 = step(p2, o2, i)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, p2, o2)
    p2r, o2r, _ = mgr.restore(2, p2, o2)
    for i in range(2, 4):
        p2r, o2r = step(p2r, o2r, i)
    np.testing.assert_allclose(p1["w"].numpy(), p2r["w"].numpy(), rtol=1e-6)


# -------------------------------------------------------------- elastic mesh
def test_best_mesh_shape_degraded_fleet():
    # full two pods
    assert best_mesh_shape(512) == ((2, 16, 16), ("pod", "data", "model"))
    # lost a pod -> single-pod mesh
    assert best_mesh_shape(272) == ((17, 16), ("data", "model"))
    # lost some hosts within the pod -> shrink 'data', keep 'model'
    shape, axes = best_mesh_shape(192)
    assert axes == ("data", "model") and shape == (12, 16)
    with pytest.raises(AssertionError):
        best_mesh_shape(8)                    # fewer than model shards
    for n in (16, 100, 256, 257, 511, 512, 1000, 4096):
        for mp in (1, 8, 16):
            assert best_mesh_shape(n, mp) == ref_best_mesh_shape(n, mp)


def test_straggler_monitor():
    mon, ref = StragglerMonitor(straggler_factor=1.5, patience=3), \
        RefMonitor(straggler_factor=1.5, patience=3)
    for step in range(6):
        for h in range(4):
            t = 1.0 if h != 2 else 3.0
            mon.record(h, t)
            ref.record(h, t)
        out = mon.stragglers()
        assert out == ref.stragglers()
    assert out == [2]
    assert mon.ewma == ref.ewma and mon.strikes == ref.strikes


# ------------------------------------------------------------- data pipeline
def test_data_stream_resume_exact():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=4, seed=7)
    a = SyntheticTokenStream(cfg)
    batches = [a.next_batch() for _ in range(5)]
    state = a.state()
    more_a = [a.next_batch() for _ in range(3)]

    b = SyntheticTokenStream(cfg)
    b.restore(state)
    more_b = [b.next_batch() for _ in range(3)]
    for x, y in zip(more_a, more_b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    # and the reference's stream, batch for batch
    ref = RefStream(RefDataConfig(vocab_size=1000, seq_len=16,
                                  global_batch=4, seed=7))
    for x in batches + more_a:
        y = ref.next_batch()
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    assert a.state() == ref.state()


def test_data_stream_host_sharding():
    cfg = DataConfig(vocab_size=1000, seq_len=8, global_batch=8, seed=3,
                     frontend_tokens=2, d_model=4)
    h0 = SyntheticTokenStream(cfg, host_id=0, num_hosts=2)
    h1 = SyntheticTokenStream(cfg, host_id=1, num_hosts=2)
    b0, b1 = h0.next_batch(), h1.next_batch()
    assert b0["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    rcfg = RefDataConfig(vocab_size=1000, seq_len=8, global_batch=8, seed=3,
                         frontend_tokens=2, d_model=4)
    for host, got in ((0, b0), (1, b1)):
        want = RefStream(rcfg, host_id=host, num_hosts=2).next_batch()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------- gradient compression
def test_compression_error_feedback_converges():
    """Error feedback: the running sum of decompressed grads tracks the true
    sum (residual stays bounded)."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 64)))
    grads = {"w": torch.from_numpy(np.array(w))}
    res = init_residuals(grads)
    ref_res = {"w": jnp.zeros((64, 64))}
    true_sum = torch.zeros(64, 64)
    deco_sum = torch.zeros(64, 64)
    for i in range(20):
        g = {"w": grads["w"] * (0.5 + 0.1 * i)}
        q, scales, res = compress(g, res)
        rq, _, ref_res = ref_compress({"w": jnp.asarray(g["w"].numpy())},
                                      ref_res)
        # an int8 step at a rounding tie apart at most, in a few entries
        diff = np.abs(q["w"].numpy().astype(int) -
                      np.asarray(rq["w"]).astype(int))
        assert diff.max() <= 1 and (diff > 0).sum() <= 4
        d = decompress(q, scales)
        true_sum = true_sum + g["w"]
        deco_sum = deco_sum + d["w"]
    # residual carries at most one step's quantization error
    err = float((true_sum - deco_sum).abs().max())
    scale = float(true_sum.abs().max())
    assert err / scale < 0.02
    q, scales, _ = compress(grads, init_residuals(grads))
    assert q["w"].dtype == torch.int8
