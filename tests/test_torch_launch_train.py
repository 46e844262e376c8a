"""PyTorch port, the training launcher (``repro_torch.launch.train``) on
the CPU, held step by step against the reference's ``make_train_step``.

The reference's own launcher installs a host mesh and then fails at the
embedding gather (``tests/test_docs.py::test_example_runs[train_smollm.py]``,
a fault of the reference), so it is not the oracle.  With no mesh its
``constrain_like_params`` returns the tree unchanged, and its
``make_train_step`` is: the reference starts from the port's initial
weights (``params_to_numpy``), takes the same batches from its own
``SyntheticTokenStream`` and the same schedule (``total_steps`` is each
run's ``--steps``), with the launcher's defaults (``cast_bf16``, max grad
norm 1.0).

Tolerance: ``LOSS_RTOL`` 1e-4 relative on each step's loss.  The first
two steps agree to f32 rounding (seen 3e-7): step 0 has lr 0 and moves no
weight.  From then on the weights carry AdamW updates computed from
gradients rounded to bf16 in both packages, summed in different orders
(``tests/test_torch_train.py`` bounds them), at ``--lr 1`` (lr 0.01-0.03
in these warm-up steps, large enough to move the loss): seen 1.6e-5.
A run resumed from its checkpoint equals the uninterrupted run exactly
(same process, same CPU arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticTokenStream as RefStream
from repro.optim.adamw import init_adamw as ref_init_adamw
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.kernels import _cuda
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.models.convert import params_to_numpy

LOSS_RTOL = 1e-4
ARGS = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--batch",
        "2", "--seq", "32", "--lr", "1.0", "--log-every", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two steps with a checkpoint at 2, then a resume to 4; and the same 4
    steps uninterrupted in another directory."""
    a = tmp_path_factory.mktemp("ckpt_a")
    b = tmp_path_factory.mktemp("ckpt_b")
    before = (_cuda.FLASH.launches, _cuda.MLSTM.launches)
    first = train.main(ARGS + ["--ckpt-dir", str(a), "--steps", "2",
                               "--ckpt-every", "2"])
    resumed = train.main(ARGS + ["--ckpt-dir", str(a), "--steps", "4",
                                 "--ckpt-every", "2"])
    straight = train.main(ARGS + ["--ckpt-dir", str(b), "--steps", "4",
                                  "--ckpt-every", "2"])
    assert (_cuda.FLASH.launches, _cuda.MLSTM.launches) == before
    return first, resumed, straight, a


def _reference_losses(cfg, lr=1.0):
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rp = jax.tree.map(jnp.asarray, params_to_numpy(params, cfg))
    rcfg = ref_arch("smollm-135m").smoke()
    rs = ref_init_adamw(rp)
    data = RefStream(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=2, seed=0))
    losses = []
    for i in range(4):
        step = jax.jit(ref_make_train_step(rcfg, total_steps=2 if i < 2
                                           else 4, peak_lr=lr))
        rp, rs, m = step(rp, rs, jax.tree.map(jnp.asarray,
                                              data.next_batch()))
        losses.append(float(m["loss"]))
    return losses, rp


def test_the_launcher_trains_and_resumes_from_its_checkpoint(runs, capsys):
    first, resumed, straight, ckpt = runs
    assert first["start_step"] == 0 and resumed["start_step"] == 2
    assert [h["step"] for h in first["history"]] == [1, 2]
    assert [h["step"] for h in resumed["history"]] == [3, 4]
    assert sorted(p.name for p in (ckpt / "smollm-135m").iterdir()) == [
        "step_000000000002", "step_000000000004"]
    assert resumed["data_state"] == straight["data_state"] == \
        {"step": 4, "seed": 0, "host_id": 0}
    assert int(resumed["opt_state"].step) == 4
    for h in first["history"] + resumed["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])


def test_a_resumed_run_equals_the_uninterrupted_one(runs):
    first, resumed, straight, _ = runs
    got = [h["loss"] for h in first["history"] + resumed["history"]]
    assert got == [h["loss"] for h in straight["history"]]
    for (n, a), (_, b) in zip(resumed["params"].named_parameters(),
                              straight["params"].named_parameters()):
        assert torch.equal(a, b), n
    for name in ("mu", "nu"):
        for k, v in getattr(resumed["opt_state"], name).items():
            assert torch.equal(v, getattr(straight["opt_state"], name)[k])


def test_the_launchers_losses_are_the_reference_steps(runs):
    first, resumed, _, _ = runs
    want, _ = _reference_losses(first["cfg"])
    got = [h["loss"] for h in first["history"] + resumed["history"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    lrs = [h["lr"] for h in first["history"] + resumed["history"]]
    np.testing.assert_allclose(lrs, [0.0, 0.01, 0.02, 0.03], rtol=1e-6)


def test_the_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
