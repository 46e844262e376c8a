"""PyTorch port, executed placements: FSDP over 'data' and tensor
parallelism over 'model' as DTensors (``distrib.sharding.device_put``)
in the train step, against the reference's unsharded ``make_train_step``.

Four gloo ranks in subprocesses (each one thread, meeting on a
``FileStore`` under ``tmp_path``) build two meshes from one group:

- (4, 1): the parameters and AdamW state of a smoke dense model
  (smollm-135m) and a smoke MoE model (granite-moe-3b-a800m) put under
  ``shardings_for(mesh, param_specs(params, fsdp_min_elems=0))`` (the
  threshold at 0, so that every leaf whose spec names 'data' is split:
  the smoke leaves are all below the default 4M elements).  Each rank
  holds ``ceil(rows / 4)`` rows of the split dim of each split leaf
  (``numel / 4`` where that divides).  Two sharded train steps on the
  global batch (each rank its rows) equal two steps of the reference's
  ``make_train_step`` with no mesh on the same weights (carried across
  with ``convert``): loss, grad norm, the updated parameters and the
  moments, within 1e-5.  Both sides run in f32 (``cast_bf16=False``):
  bf16 copies would round each rank's gradient before the reduction.
- (2, 2): the same models with the dense weights split over 'model'
  (tensor parallel: heads, FFN hidden and vocab) and the experts sliced
  over 'model' (``moe_ep`` on each rank's token shard, 4 tokens: no
  choice is dropped) and FSDP over 'data': the same agreement, so the
  clip's global norm counts every shard once, as the one-rank norm.
- A checkpoint saved from the sharded state after step 1 (every rank
  gathers, rank 0 writes) and restored into freshly distributed
  templates gives the uninterrupted run's step 2 exactly.
- ``launch.train`` under a (4, 1) mesh with its FSDP threshold
  (``launch.train.FSDP_MIN_ELEMS``) set to 0 holds its parameters and
  AdamW state as DTensors, each rank a quarter.
- One config of each family (dense, moe, hybrid, ssm, vlm, audio) serves
  on DTensor parameters over (2, 2) with the plain parameters' numbers:
  the prefill step's logits (flash and mLSTM dispatchers on each rank's
  own heads, here their plain versions) and three decode steps against a
  DTensor cache (each rank writing its own shard).

In this process, on a gloo group of one (mesh (1, 1)), the launcher's
train step with bf16 copies of the weights (``cast_bf16=True``): one step
on DTensor parameters equals one on the plain parameters bit for bit
(loss, grad norm, and every leaf's gradient, read from the first AdamW
moment, ``(1 - b1)`` times the clipped gradient after one step), with the
activations in float32 (the smoke config's) and in bfloat16 (the
full-width config's).  A control lane, the plain parameters on the
batch's rows reversed (the same step in exact arithmetic), gives the
step's own rounding spread.  Autograd through the composite logsumexp
that the DTensor lane used to take parted the lanes by bf16 roundings
(on the card, its grad norm by 2.78e-4 relative against the control's
9.7e-7); the case that restores it shows a leaf more than 10x the
control's difference.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
TOL = 1e-5
ARCHS = ("smollm-135m", "granite-moe-3b-a800m")
# one config of each family, served on DTensors
SERVE = ("smollm-135m", "granite-moe-3b-a800m", "hymba-1.5b", "xlstm-1.3b",
         "internvl2-1b", "seamless-m4t-medium")
B, S = 4, 4
# the launcher's default peak: step 2 takes lr = peak / 100 (warm-up), so
# an update moves a weight by about 3e-6 and the moments carry the grads
LR = 3e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, tmp = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_arch
from repro_torch.distrib.checkpoint import CheckpointManager
from repro_torch.distrib.sharding import (device_put, is_dtensor,
                                          param_specs, set_active_mesh,
                                          shardings_for)
from repro_torch.models import api
from repro_torch.models.convert import params_to_numpy
from repro_torch.optim.adamw import init_adamw
from repro_torch.train.step import make_train_step

B, S, LR = %(B)d, %(S)d, %(LR)r
result = {}


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def batches(cfg):
    rng = np.random.default_rng(7)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int32)) for k in
             ("tokens", "targets")} for _ in range(2)]


def distributed(cfg, mesh):
    params = api.init_params(0, cfg, device="cpu")
    params = device_put(params, shardings_for(
        mesh, param_specs(params, fsdp_min_elems=0)))
    return params, init_adamw(params)


def sharded_batch(batch, mesh):
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    pl = tuple(Shard(0) if n == "data" else Replicate()
               for n in mesh.mesh_dim_names)
    return {k: distribute_tensor(v, mesh, pl) for k, v in batch.items()}


for mesh_shape in ((4, 1), (2, 2)):
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    set_active_mesh(mesh)
    tag = "x".join(map(str, mesh_shape))
    for arch in %(ARCHS)r:
        cfg = get_arch(arch).smoke()
        key = f"{tag}_{arch}"
        params, opt = distributed(cfg, mesh)
        # what each rank holds of each leaf
        held = {}
        for n, p in params.named_parameters():
            parts, even = 1, True
            for q, size in zip(p.placements, mesh.shape):
                if q.is_shard():
                    parts *= size
                    even = even and p.shape[q.dim] %% size == 0
            held[n] = [int(p.to_local().numel()), int(p.numel()), parts,
                       even, [q.dim if q.is_shard() else None
                              for q in p.placements]]
        result[key + "_held"] = np.array(json.dumps(held))
        result[key + "_all_dtensor"] = np.array(
            all(is_dtensor(p) for p in params.parameters())
            and all(is_dtensor(t) for t in opt.mu.values()))
        step = make_train_step(cfg, total_steps=4, peak_lr=LR,
                               cast_bf16=False)
        hist = []
        for i, batch in enumerate(batches(cfg)):
            params, opt, m = step(params, opt, sharded_batch(batch, mesh))
            hist.append([float(m["loss"]), float(m["grad_norm"])])
            if i == 0 and mesh_shape == (2, 2):
                ck = CheckpointManager(f"{tmp}/ck_{key}")
                ck.save(1, params, opt, write=rank == 0)
                dist.barrier()
        result[key + "_hist"] = np.array(hist)
        for n, v in flat_tree(params_to_numpy(params, cfg)).items():
            result[f"{key}_p.{n}"] = v
        flat = {n: p for n, p in params.named_parameters()}
        result[key + "_pnames"] = np.array(sorted(flat))
        result[key + "_pvals"] = np.concatenate(
            [p.detach().full_tensor().reshape(-1).numpy() for _, p in
             sorted(flat.items())])
        for f in ("mu", "nu"):
            for n, v in flat_tree(params_to_numpy(getattr(opt, f),
                                                  cfg)).items():
                result[f"{key}_{f}.{n}"] = v
        if mesh_shape == (2, 2):
            # restore step 1 into fresh templates and take step 2 again
            fresh, fopt = distributed(cfg, mesh)
            ck = CheckpointManager(f"{tmp}/ck_{key}")
            fresh, fopt, _ = ck.restore(1, fresh, fopt)
            fresh, fopt, m = make_train_step(
                cfg, total_steps=4, peak_lr=LR, cast_bf16=False)(
                    fresh, fopt, sharded_batch(batches(cfg)[1], mesh))
            result[key + "_resumed_hist"] = np.array(
                [float(m["loss"]), float(m["grad_norm"])])
            result[key + "_resumed_pvals"] = np.concatenate(
                [p.detach().full_tensor().reshape(-1).numpy() for _, p in
                 sorted(dict(fresh.named_parameters()).items())])
    set_active_mesh(None)

# every family's prefill and one decode step on DTensor parameters and a
# DTensor cache over (2, 2), against the same weights as plain tensors
import copy
from repro_torch.launch.specs import _cache_specs
from repro_torch.models.frontends import frontend_shape
from repro_torch.train.step import make_decode_step, make_prefill_step
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
set_active_mesh(mesh)
for arch in %(SERVE)r:
    cfg = get_arch(arch).smoke()
    plain = api.init_params(0, cfg, device="cpu")
    sharded = device_put(copy.deepcopy(plain), shardings_for(
        mesh, param_specs(plain, fsdp_min_elems=0)))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32))
    batch = {"tokens": tokens}
    shape = frontend_shape(cfg, B)
    if shape is not None:
        batch["frontend"] = rng.standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        # the plain weights with no mesh (the MoE dense); 4 tokens a
        # shard on the mesh, so moe_ep drops nothing
        set_active_mesh(None)
        want = make_prefill_step(cfg)(plain, batch)
        set_active_mesh(mesh)
        got = make_prefill_step(cfg)(sharded, {
            **batch, "tokens": sharded_batch({"t": tokens}, mesh)["t"]})
        result[f"serve_{arch}_prefill"] = np.array(
            [float((got.full_tensor() - want).abs().max()),
             float(want.abs().max())])
        cache = api.init_cache(cfg, B, 16, device="cpu")
        dcache = device_put(copy.deepcopy(cache), shardings_for(
            mesh, _cache_specs(cache, mesh, batch_one=False)))
        step = make_decode_step(cfg)
        tok = tokens[:, :1]
        errs = []
        for _ in range(3):
            nxt, cache = step(plain, tok, cache)
            dnxt, dcache = step(sharded, sharded_batch({"t": tok}, mesh)["t"],
                                dcache)
            errs.append(float((dnxt.full_tensor() != nxt).sum()))
            tok = nxt
        flat_c = flat_tree({k: v for k, v in cache.items()})
        flat_d = flat_tree({k: v for k, v in dcache.items()})
        # each cache leaf: its error over its own tolerance (1e-5 of its
        # scale in float32; one bf16 step at its scale for a bf16 leaf)
        worst = 0.0
        for k in flat_c:
            a, b = flat_d[k].full_tensor(), flat_c[k]
            if not b.is_floating_point():
                worst = max(worst, float((a != b).sum()))
                continue
            scale = max(1.0, float(b.float().abs().max()))
            tol = (2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-5) * scale
            worst = max(worst, float((a.float() - b.float()).abs().max())
                        / tol)
        result[f"serve_{arch}_decode"] = np.array(errs + [worst])
set_active_mesh(None)

# launch.train on the (4, 1) host mesh with every 'data' spec split (the
# FSDP threshold at 0: the smoke leaves are all below the default)
from repro_torch.launch import train
train.FSDP_MIN_ELEMS = 0
run = train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                  "--steps", "1", "--batch", "4", "--seq", "4",
                  "--ckpt-dir", f"{tmp}/launch", "--log-every", "1"])
emb = run["params"].embed
result["launch_embed"] = np.array([is_dtensor(emb),
                                   emb.to_local().shape[1] * 4
                                   == emb.shape[1]])
result["launch_mu_dtensor"] = np.array(
    all(is_dtensor(t) for t in run["opt_state"].mu.values()))
result["launch_loss"] = np.array([run["history"][0]["loss"]])
np.savez(out, **result)
dist.destroy_process_group()
''' % {"B": B, "S": S, "LR": LR, "ARCHS": ARCHS, "SERVE": SERVE}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    world = 4
    store = str(tmp / "store")
    outs = [str(tmp / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), store, outs[r],
         str(tmp)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errors.append(f"rank {r} exit {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(o)) for o in outs]


def _reference(arch):
    """Two steps of the reference's unsharded train step (f32) on the
    port's seed-0 weights and the workers' batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_arch
    from repro.optim.adamw import init_adamw as ref_init_adamw
    from repro.train.step import make_train_step as ref_make_train_step
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.models.convert import params_to_numpy

    cfg = get_arch(arch).smoke()
    params = api.init_params(0, cfg, device="cpu")
    rp = jax.tree.map(jnp.asarray, params_to_numpy(params, cfg))
    rs = ref_init_adamw(rp)
    step = jax.jit(ref_make_train_step(ref_arch(arch).smoke(), total_steps=4,
                                       peak_lr=LR, cast_bf16=False))
    rng = np.random.default_rng(7)
    hist = []
    for _ in range(2):
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
                 for k in ("tokens", "targets")}
        rp, rs, m = step(rp, rs, batch)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(hist), {"p": jax.tree.map(np.asarray, rp),
                            "mu": jax.tree.map(np.asarray, rs.mu),
                            "nu": jax.tree.map(np.asarray, rs.nu)}


@pytest.fixture(scope="module")
def references():
    return {a: _reference(a) for a in ARCHS}


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_equal_the_references_unsharded_steps(
        ranks, references, arch, mesh):
    want_hist, want_params = references[arch]
    key = f"{mesh}_{arch}"
    for got in ranks:
        assert bool(got[key + "_all_dtensor"])
        # loss and the clip's global norm (every shard counted once)
        np.testing.assert_allclose(got[key + "_hist"], want_hist, rtol=TOL,
                                   atol=TOL)
        for f in ("p", "mu", "nu"):
            for name, want in _flat(want_params[f]).items():
                np.testing.assert_allclose(got[f"{key}_{f}.{name}"], want,
                                           rtol=TOL, atol=TOL,
                                           err_msg=f + " " + name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_share_of_each_split_leaf(ranks, arch, mesh):
    """numel / shards where the split divides; DTensor's rule otherwise
    (the first ranks hold ceil(rows / parts) rows, the last fewer)."""
    split = 0
    for got in ranks:
        held = json.loads(str(got[f"{mesh}_{arch}_held"]))
        for name, (local, numel, parts, even, pl) in held.items():
            if even:
                assert local * parts == numel, (name, local, numel, pl)
            else:
                assert local <= -(-numel // parts) * 2, (name, local, pl)
            split += parts > 1
    assert split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_clip_norm_on_two_by_two_with_sliced_experts(ranks, references,
                                                     arch):
    """(2, 2): experts sliced over 'model' (MoE) and dense weights split
    over both axes: the clip's norm is the one-rank norm."""
    want = references[arch][0][:, 1]
    for got in ranks:
        held = json.loads(str(got[f"2x2_{arch}_held"]))
        if arch.startswith("granite"):
            local, numel, parts, even, pl = held["layers.0.moe.w_gate"]
            # experts over 'model', d over 'data': a quarter each
            assert pl == [1, 0] and local * 4 == numel
        np.testing.assert_allclose(got[f"2x2_{arch}_hist"][:, 1], want,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_sharded_checkpoint_resumes_the_uninterrupted_run(ranks, arch):
    for got in ranks:
        key = f"2x2_{arch}"
        np.testing.assert_array_equal(got[key + "_resumed_hist"],
                                      got[key + "_hist"][1])
        np.testing.assert_array_equal(got[key + "_resumed_pvals"],
                                      got[key + "_pvals"])


@pytest.mark.parametrize("arch", SERVE)
def test_every_family_serves_on_dtensors_with_the_plain_numbers(ranks, arch):
    """Prefill (B 4 x S 4) and three greedy decode steps on (2, 2), in
    float32: the last-position logits within 1e-5 of the output's scale,
    the same tokens, and every cache leaf within 1e-5 of its scale (the
    bf16 K/V and conv caches within one bf16 step: float32 values that
    differ in their last bits may round to neighbouring bf16 values)."""
    for got in ranks:
        err, scale = got[f"serve_{arch}_prefill"]
        assert err <= TOL * max(1.0, scale), (err, scale)
        dec = got[f"serve_{arch}_decode"]
        assert (dec[:-1] == 0).all(), dec
        assert dec[-1] <= 1.0, dec


def test_launch_train_holds_dtensors_under_its_mesh(ranks):
    for got in ranks:
        assert got["launch_embed"].all()
        assert bool(got["launch_mu_dtensor"])
        assert np.isfinite(got["launch_loss"]).all()


# ------------------------------------- world 1: bf16 copies, DTensor vs plain
WB, WS = 4, 64


def _composite_logsumexp(x):
    """The DTensor lane's former logsumexp: autograd through the
    max-shifted composite (backward ``grad / sum * exp(x - max)``)."""
    m = x.amax(dim=-1, keepdim=True).detach()
    return (x - m).exp().sum(dim=-1).log() + m[..., 0]


def _world1_step(dtype, lanes=("plain", "dtensor", "control"),
                 logsumexp=None):
    """One ``make_train_step(cast_bf16=True)`` step of smollm-135m
    ``.smoke()`` (activations in ``dtype``) from one initial state in each
    lane, on a gloo group of one and mesh (1, 1): {lane: (loss, grad norm,
    {leaf: first moment})}.  ``logsumexp`` replaces the DTensor lane's
    logsumexp when given."""
    import copy

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.distrib.sharding import (batch_spec, device_put,
                                              param_specs, placements,
                                              set_active_mesh,
                                              shardings_for)
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import api, lm
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.step import make_train_step

    cfg = get_arch("smollm-135m").smoke().replace(dtype=dtype)
    started = init_process_group(torch.device("cpu"))
    saved = lm._LogSumExp.apply
    try:
        mesh = make_host_mesh()
        set_active_mesh(mesh)
        if logsumexp is not None:
            lm._LogSumExp.apply = logsumexp
        plain = api.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        toks = torch.from_numpy(np.random.default_rng(24).integers(
            0, cfg.vocab_size, (WB, WS + 1)).astype(np.int32))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "targets": toks[:, 1:].contiguous()}

        def whole(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def dtensor_batch():
            return {k: DTensor.from_local(v, mesh, placements(
                mesh, batch_spec(mesh, v.dim()))) for k, v in batch.items()}

        make = {"plain": lambda: (copy.deepcopy(plain), batch),
                "dtensor": lambda: (device_put(copy.deepcopy(plain),
                                               shardings_for(
                                                   mesh, param_specs(plain))),
                                    dtensor_batch()),
                "control": lambda: (copy.deepcopy(plain),
                                    {k: v.flip(0).contiguous()
                                     for k, v in batch.items()})}
        step = make_train_step(cfg, total_steps=10, peak_lr=1e-2,
                               cast_bf16=True)
        got = {}
        for lane in lanes:
            params, b = make[lane]()
            if lane == "dtensor":
                assert all(isinstance(p.data, DTensor)
                           for p in params.parameters())
            _, opt, m = step(params, init_adamw(params), b)
            got[lane] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: whole(v).detach().clone()
                          for k, v in opt.mu.items()})
        return got
    finally:
        lm._LogSumExp.apply = saved
        set_active_mesh(None)
        if started:
            dist.destroy_process_group()


def _leaf_diffs(got, lane):
    """Each leaf's max |lane - plain| over the plain leaf's max |.|."""
    ref = got["plain"][2]
    return {k: float((v - ref[k]).abs().max() / ref[k].abs().max())
            for k, v in got[lane][2].items()}


@pytest.fixture(scope="module")
def world1():
    return {dt: _world1_step(dt) for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_dtensor_step_equals_the_plain_step_at_world_1(world1, dtype):
    got = world1[dtype]
    (lp, gp, mp), (ld, gd, md) = got["plain"], got["dtensor"]
    assert np.isfinite(lp) and gp > 0
    assert ld == lp and gd == gp
    assert sorted(md) == sorted(mp)
    for k in mp:
        assert torch.equal(md[k], mp[k]), (k, _leaf_diffs(got, "dtensor")[k])
    # the control lane is the same step in exact arithmetic: it agrees
    # with the plain lane only to the step's rounding
    ctrl = _leaf_diffs(got, "control")
    assert max(ctrl.values()) < 1e-2
    assert abs(got["control"][1] - gp) / gp < 1e-4


def test_the_composite_logsumexp_backward_parts_the_lanes(world1):
    got = dict(world1["bfloat16"])
    got.update(_world1_step("bfloat16", lanes=("dtensor",),
                            logsumexp=_composite_logsumexp))
    assert got["dtensor"][0] == got["plain"][0]        # the same forward
    dt, ctrl = _leaf_diffs(got, "dtensor"), _leaf_diffs(got, "control")
    parted = [k for k in dt if dt[k] > 10 * ctrl[k]]
    assert parted, (dt, ctrl)
