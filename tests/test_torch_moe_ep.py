"""PyTorch port, expert parallelism (``models.moe.moe_ep``) and data
parallelism over ``torch.distributed`` on the CPU (gloo), against the
reference's ``moe_ep`` and the port's own dense oracle.

- The reference's ``moe_ep`` runs on qwen3-moe-30b-a3b's smoke config
  (``init_moe(..., expert_shards=4)``: 8 experts) on a (2, 4) mesh of 8
  forced host devices, in a subprocess (as ``tests/test_moe_ep.py``), at
  ``capacity_factor`` 8.0 (dropless) and 1.0 (choices dropped), and saves
  its numpy outputs.  The port's ``moe_ep`` runs in 8 gloo processes on a
  (2, 4) ``DeviceMesh``, each rank holding only its 2 experts (carried by
  ``convert.to_tensor``) and its token shard: its outputs equal the
  reference's within 1e-5 (the same f32 arithmetic in another order; the
  reference's own test allows 3e-2 against its dense oracle), and at 1.0
  it drops the same choices (its keep masks equal a numpy ranking of the
  reference's routes).
- At dropless capacity, the gradients of ``x``, of each rank's experts
  and of the router (summed over 'data' as the DP step would) equal
  autograd through the port's ``moe_dense`` in one process, within 1e-5;
  so do ``moe()``'s output and gradients for a layer with a shared expert
  held whole on every rank (the shared MLP on the whole input, the whole
  expert stacks' gradients summed over 'model').
- The layout helpers: the sequence split and gather over 'model' and
  their gradients, and ``S % n != 0`` raising; ``make_elastic_mesh``;
  ``init_params(mesh=)`` holding each rank's experts with the whole
  layer's values.
- n = 1 (one process) equals ``moe_dense`` at dropless capacity.
- A two-rank data-parallel run of ``launch.train`` (granite smoke, and
  smollm smoke; 2 steps, f32 gradients) equals the one-rank run on the
  global batch within 1e-6, and a
  two-rank expert-parallel train step (mesh (1, 2)) equals the one-rank
  step: both hold the gradient reductions.  Per-shard capacity depends on
  the shard's token count, so these need runs that drop no choice: the
  test asserts that none was dropped.

Every child process has its own timeout, runs one thread, and meets the
others through a ``FileStore`` under ``tmp_path`` (tier-1 runs files in
parallel, so no fixed port).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
TOL = 1e-5


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


REFERENCE = """
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, numpy as np
from repro.configs import get_arch
from repro.models.moe import _route, init_moe, moe_ep
cfg = get_arch("qwen3-moe-30b-a3b").smoke()
mesh = jax.make_mesh((2, 4), ("data", "model"))
p = init_moe(jax.random.PRNGKey(0), cfg, expert_shards=4)
out = {k: np.asarray(v) for k, v in p.items()}
for tag, S, cf in (("hi", 16, 8.0), ("lo", 64, 1.0)):
    x = jax.random.normal(jax.random.PRNGKey(1), (2, S, cfg.d_model)) * 0.5
    out["x_" + tag] = np.asarray(x)
    out["out_" + tag] = np.asarray(moe_ep(p, x, cfg, mesh,
                                          capacity_factor=cf))
    out["idx_" + tag] = np.asarray(_route(p, x, cfg.moe)[1])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_ep") / "ref.npz")
    r = subprocess.run([sys.executable, "-c", REFERENCE, path],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
scenario, rank, world, store, ref, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_arch
from repro_torch.distrib.sharding import mesh_axes, set_active_mesh
from repro_torch.models import moe
from repro_torch.models.convert import to_tensor
result = {}


def layer(R, experts):
    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    p = moe.MoE(cfg, expert_shards=4, experts=experts)
    lo, hi = p.experts
    with torch.no_grad():
        p.router.copy_(to_tensor(R["router"]))
        for k in ("w_gate", "w_up", "w_down"):
            getattr(p, k).copy_(to_tensor(R[k][lo:hi]))
    return cfg, p


if scenario == "ep":
    R = dict(np.load(ref))
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    assert (d, m) == divmod(rank, 4)
    cfg, p = layer(R, (2 * m, 2 * m + 2))
    for tag, cf in (("hi", 8.0), ("lo", 1.0)):
        x = torch.from_numpy(R["x_" + tag])
        s = x.shape[1] // 4
        xs = x[d:d + 1, m * s:(m + 1) * s]
        with torch.no_grad(), moe.count_drops() as drops:
            y = moe.moe_ep(p, xs, cfg, mesh, capacity_factor=cf)
        result["out_" + tag] = y.numpy()
        result["keep_" + tag] = drops["keep"][0].numpy()
    # gradients at dropless capacity against moe_dense on the whole layer
    x = torch.from_numpy(R["x_hi"])
    s = x.shape[1] // 4
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape).astype(np.float32))
    xs = x[d:d + 1, m * s:(m + 1) * s].clone().requires_grad_()
    y = moe.moe_ep(p, xs, cfg, mesh, capacity_factor=8.0)
    (y * g[d:d + 1, m * s:(m + 1) * s]).sum().backward()
    for w in (p.router, p.w_gate, p.w_up, p.w_down):
        dist.all_reduce(w.grad, group=mesh.get_group("data"))
    _, full = layer(R, None)
    xf = x.clone().requires_grad_()
    (moe.moe_dense(full, xf, cfg) * g).sum().backward()
    sl = slice(2 * m, 2 * m + 2)
    errs = {"x": (xs.grad - xf.grad[d:d + 1, m * s:(m + 1) * s]).abs().max(),
            "router": (p.router.grad - full.router.grad).abs().max()}
    for k in ("w_gate", "w_up", "w_down"):
        errs[k] = (getattr(p, k).grad - getattr(full, k).grad[sl]).abs().max()
    result["grad_err"] = np.array([float(v) for v in errs.values()])
    result["grad_scale"] = np.array([float(xf.grad.abs().max())])
    # the layout helpers: split and gather over 'model', and their grads
    h = torch.randn(2, 8, 4, generator=torch.Generator().manual_seed(3))
    h.requires_grad_()
    z = moe.seq_gather(3.0 * moe.seq_split(h, mesh), mesh)
    assert torch.equal(z, 3.0 * h)
    z.sum().backward()
    assert torch.equal(h.grad, torch.full_like(h, 3.0))
    try:
        moe.moe(p, torch.zeros(1, 6, cfg.d_model), cfg, mesh)
    except ValueError as e:
        result["split_error"] = np.array([str(e)])
    # moe() on the whole input, replicated over 'model', of a layer with a
    # shared expert that every rank holds whole: its sequence split and
    # gather, the shared MLP on the whole input, and the whole stacks'
    # and the router's gradients summed over 'model'.  A shard has 4
    # tokens, so capacity 1.25's 4 slots an expert drop nothing.
    import dataclasses
    cfg_s = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                num_shared_experts=1))
    whole_s, full_s = (moe.MoE(cfg_s, expert_shards=4).reset_parameters(
        torch.Generator().manual_seed(11)) for _ in range(2))
    xw = x[d:d + 1].clone().requires_grad_()
    with moe.count_drops() as drops:
        y = moe.moe(whole_s, xw, cfg_s, mesh)
    (y * g[d:d + 1]).sum().backward()
    for w in whole_s.parameters():
        dist.all_reduce(w.grad, group=mesh.get_group("data"))
    xf = x.clone().requires_grad_()
    y_dense = moe.moe_dense(full_s, xf, cfg_s)
    (y_dense * g).sum().backward()
    grads = dict(full_s.named_parameters())
    errs = [float((y - y_dense[d:d + 1]).abs().max()),
            float((xw.grad - xf.grad[d:d + 1]).abs().max())] + [
        float((w.grad - grads[n].grad).abs().max())
        for n, w in whole_s.named_parameters()]
    result["shared_names"] = np.array(
        [n for n, _ in whole_s.named_parameters()])
    result["shared_err"] = np.array(errs)
    result["shared_dropped"] = np.array([drops["dropped"],
                                         drops["choices"]])
    # a rank's experts drawn alone equal its slice of the whole layer's
    from repro_torch.models import api
    whole = api.init_params(0, cfg, device="cpu")
    mine = api.init_params(0, cfg, device="cpu", mesh=mesh)
    E_loc = whole.layers[0].moe.w_gate.shape[0] // 4
    result["local_init"] = np.array([
        tuple(mine.layers[0].moe.w_gate.shape) ==
        (E_loc, *whole.layers[0].moe.w_gate.shape[1:])] + [
        torch.equal(a, b[m * E_loc:(m + 1) * E_loc] if a.shape != b.shape
                    else b)
        for a, b in zip(mine.parameters(), whole.parameters())])
    # elastic meshes over the 8 ranks
    from repro_torch.distrib.elastic import make_elastic_mesh
    e4 = make_elastic_mesh(model_parallel=4)
    e3 = make_elastic_mesh(model_parallel=3)
    result["elastic"] = np.array([
        *mesh_axes(e4).values(), *mesh_axes(e3).values(),
        e3.get_coordinate() is not None])

if scenario == "train":
    import json
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.step import make_train_step
    import functools
    from repro_torch.train import step as step_mod
    train.make_train_step = functools.partial(step_mod.make_train_step,
                                              cast_bf16=False)
    # data-parallel launch.train runs on the (world, 1) host mesh
    for tag, argv in json.loads(sys.argv[7]).items():
        with moe.count_drops() as drops:
            run = train.main(argv + ["--ckpt-dir", out + "." + tag])
        result[tag + "_dropped"] = np.array([drops["dropped"]])
        result[tag + "_rows"] = np.array([run["rows"].start,
                                          run["rows"].stop])
        result[tag + "_mesh"] = np.array(list(run["mesh"].values()))
        result[tag + "_hist"] = np.array([[h["loss"], h["grad_norm"]]
                                          for h in run["history"]])
        for n, t in run["params"].named_parameters():
            result[tag + "_p." + n] = t.detach().numpy()
        for f in ("mu", "nu"):
            for n, t in getattr(run["opt_state"], f).items():
                result[f"{tag}_{f}." + n] = t.numpy()
    # an expert-parallel train step on a (1, world) mesh
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    set_active_mesh(mesh)
    cfg = get_arch("granite-moe-3b-a800m").smoke()
    params = api.init_params(0, cfg, device="cpu")
    opt = init_adamw(params)
    step = make_train_step(cfg, total_steps=2)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 4))
    batch = {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, 1))}
    hist = []
    with moe.count_drops() as drops:
        for _ in range(2):
            params, opt, mt = step(params, opt, batch)
            hist.append([float(mt["loss"]), float(mt["grad_norm"])])
    set_active_mesh(None)
    result["ep_dropped"] = np.array([drops["dropped"]])
    result["ep_hist"] = np.array(hist)
    for n, t in params.named_parameters():
        result["ep_p." + n] = t.detach().numpy()

np.savez(out, **result)
dist.barrier()
dist.destroy_process_group()
'''


def _spawn(tmp_path, scenario, world, ref="-", extra=()):
    """Run WORKER in ``world`` processes; returns each rank's saved dict."""
    store = str(tmp_path / f"store_{scenario}")
    outs = [str(tmp_path / f"{scenario}_{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, scenario, str(r), str(world), store,
         ref, outs[r], *extra], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
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


@pytest.fixture(scope="module")
def ep_ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "ref.npz", **reference)
    return _spawn(tmp, "ep", 8, str(tmp / "ref.npz"))


def _keep_of(idx, E, cf):
    """The reference's capacity rule in numpy on one shard's routes."""
    flat = idx.reshape(-1)
    T, K = idx.shape[0], idx.shape[1]
    C = max(4, -(-int(cf * K * T / E) // 4) * 4)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    seen = {}
    for i in order:
        rank[i] = seen.get(flat[i], 0)
        seen[flat[i]] = rank[i] + 1
    return rank < C


@pytest.mark.parametrize("tag", ["hi", "lo"])
def test_moe_ep_over_eight_ranks_is_the_references(reference, ep_ranks,
                                                   tag):
    x = reference["x_" + tag]
    s = x.shape[1] // 4
    E = reference["router"].shape[-1]
    cf = 8.0 if tag == "hi" else 1.0
    dropped = 0
    for rank, got in enumerate(ep_ranks):
        d, m = divmod(rank, 4)
        want = reference["out_" + tag][d:d + 1, m * s:(m + 1) * s]
        np.testing.assert_allclose(got["out_" + tag], want, rtol=TOL,
                                   atol=TOL)
        idx = reference["idx_" + tag][d, m * s:(m + 1) * s]
        keep = _keep_of(idx, E, cf)
        np.testing.assert_array_equal(got["keep_" + tag], keep)
        dropped += int((~keep).sum())
    assert (dropped == 0) == (tag == "hi"), dropped


def test_moe_ep_gradients_are_moe_denses(ep_ranks):
    for got in ep_ranks:
        assert float(got["grad_scale"][0]) > 0.1
        assert got["grad_err"].max() <= TOL, got["grad_err"]


def test_shared_experts_and_whole_stacks_over_eight_ranks(ep_ranks):
    """``moe()`` with a shared expert, every rank holding the whole layer,
    on a (2, 4) mesh: its output and the gradients of ``x`` and of every
    weight (summed over 'data', as the DP step would) are ``moe_dense``'s
    on the whole batch."""
    for got in ep_ranks:
        names = got["shared_names"].tolist()
        assert any(n.startswith("shared.") for n in names), names
        # 4 tokens a shard at top-2
        assert got["shared_dropped"].tolist() == [0, 4 * 2]
        assert got["shared_err"].max() <= TOL, dict(
            zip(["out", "x"] + names, got["shared_err"]))


def test_layout_helpers_and_elastic_meshes(ep_ranks):
    for rank, got in enumerate(ep_ranks):
        # init_params(mesh=): the rank's experts, the same values
        assert got["local_init"].all()
        assert "does not split over 4 ranks" in str(got["split_error"][0])
        # (2, 4) over all 8; (2, 3) over ranks 0-5
        assert got["elastic"].tolist() == [2, 4, 2, 3, rank < 6]


def test_one_rank_is_moe_dense_at_dropless_capacity():
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import moe

    cfg = get_arch("granite-moe-3b-a800m").smoke()
    p = moe.MoE(cfg).reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    started = init_process_group("cpu")
    try:
        mesh = make_host_mesh()
        E = p.router.shape[-1]
        with torch.no_grad():
            with moe.count_drops() as drops:
                ep = moe.moe_ep(p, x, cfg, mesh, capacity_factor=E / 2)
            with moe.count_drops() as default:
                via = moe.moe(p, x, cfg, mesh=mesh)
            dense = moe.moe_dense(p, x, cfg)
    finally:
        if started:
            dist.destroy_process_group()
    # T = 32 tokens, top-2
    assert drops["dropped"] == 0 and drops["choices"] == 64
    np.testing.assert_allclose(ep.numpy(), dense.numpy(), rtol=TOL, atol=TOL)
    # moe() takes moe_ep at its default capacity 1.25: C = 8 per expert
    assert default["choices"] == 64 and via.shape == x.shape


def test_one_rank_at_a_dropping_capacity_is_moe_dense_on_its_keep_mask():
    """At capacity 1.0 on 64 tokens choices are dropped; ``moe_dense``
    with ``moe_ep``'s keep mask (the dropped choices weighing zero) is its
    plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import moe

    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    p = moe.MoE(cfg).reset_parameters(torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    started = init_process_group("cpu")
    try:
        with torch.no_grad(), moe.count_drops() as drops:
            ep = moe.moe_ep(p, x, cfg, make_host_mesh(), capacity_factor=1.0)
    finally:
        if started:
            dist.destroy_process_group()
    keep = drops["keep"][0]
    assert 0 < drops["dropped"] < drops["choices"] == 64 * 2
    # the loads count every choice, kept or not
    assert drops["load"][0].sum() == 128 and drops["load"][0].max() > 8
    with torch.no_grad():
        plain = moe.moe_dense(p, x, cfg, keep=keep)
        full = moe.moe_dense(p, x, cfg)
    np.testing.assert_allclose(ep.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    assert float((ep - full).abs().max()) > 1e-2


# A shard's capacity is at least 4 slots an expert, and a token takes an
# expert once, so a run of at most 4 tokens a shard drops no choice:
# granite's one-rank run sees all 4 of its tokens; smollm has no MoE.  The
# default peak lr (3e-4, so 3e-6 at step 2 in warm-up): AdamW's update
# mu / (sqrt(nu) + 1e-8) turns the rounding of a gradient that cancels to
# ~1e-8 into an O(1) change, which a larger lr would carry into the
# weights; the moments hold the gradients to 1e-6 either way.
COMMON = ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-every",
          "2"]
RUNS = {"granite": ["--arch", "granite-moe-3b-a800m", "--batch", "2",
                    "--seq", "2"] + COMMON,
        "smollm": ["--arch", "smollm-135m", "--batch", "4", "--seq", "16"]
        + COMMON}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Two ranks; then the same on one rank in this process.  The
    launcher's step runs with f32 gradients (``cast_bf16=False``): its
    default bf16 copies round each rank's gradient to bf16 before the
    average, so two ranks and one would differ by bf16's rounding (~4e-5
    of the grad norm here), as the reference's would."""
    import functools
    import json

    from repro_torch.configs import get_arch
    from repro_torch.distrib.sharding import set_active_mesh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import api, moe
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.step import make_train_step

    tmp = tmp_path_factory.mktemp("dp")
    two = _spawn(tmp, "train", 2, extra=[json.dumps(RUNS)])
    one = {}
    saved = train.make_train_step
    train.make_train_step = functools.partial(make_train_step,
                                              cast_bf16=False)
    try:
        for tag, argv in RUNS.items():
            with moe.count_drops() as drops:
                run = train.main(argv + ["--ckpt-dir",
                                         str(tmp / f"one.{tag}")])
            one[tag] = (run, drops["dropped"])
    finally:
        train.make_train_step = saved
    # the expert-parallel step's one-rank counterpart: a (1, 1) mesh
    cfg = get_arch("granite-moe-3b-a800m").smoke()
    started = init_process_group("cpu")
    try:
        set_active_mesh(make_host_mesh())
        params = api.init_params(0, cfg, device="cpu")
        opt = init_adamw(params)
        step = make_train_step(cfg, total_steps=2)
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 4))
        batch = {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(np.roll(toks, -1, 1))}
        hist = []
        with moe.count_drops() as drops:
            for _ in range(2):
                params, opt, mt = step(params, opt, batch)
                hist.append([float(mt["loss"]), float(mt["grad_norm"])])
        ep_one = (params, hist, drops["dropped"])
    finally:
        set_active_mesh(None)
        if started:
            dist.destroy_process_group()
    return two, one, ep_one, tmp


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_two_rank_data_parallel_run_is_the_one_rank_run(train_runs, tag):
    two, one, _, tmp = train_runs
    run, dropped = one[tag]
    assert dropped == 0
    B = int(RUNS[tag][RUNS[tag].index("--batch") + 1])
    for rank, got in enumerate(two):
        assert int(got[tag + "_dropped"][0]) == 0
        assert got[tag + "_mesh"].tolist() == [2, 1]
        assert got[tag + "_rows"].tolist() == [rank * B // 2,
                                               (rank + 1) * B // 2]
        want = np.array([[h["loss"], h["grad_norm"]]
                         for h in run["history"]])
        np.testing.assert_allclose(got[tag + "_hist"], want, rtol=1e-6,
                                   atol=1e-6)
        for n, t in run["params"].named_parameters():
            np.testing.assert_allclose(got[tag + "_p." + n],
                                       t.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=n)
        for f in ("mu", "nu"):
            for n, t in getattr(run["opt_state"], f).items():
                np.testing.assert_allclose(got[f"{tag}_{f}." + n],
                                           t.numpy(), rtol=0, atol=1e-6,
                                           err_msg=n)
    # only rank 0 wrote a checkpoint
    name = run["cfg"].name
    for rank in (0, 1):
        ck = tmp / f"train_{rank}.npz.{tag}" / name / "step_000000000002"
        assert ck.is_dir() == (rank == 0)


def test_two_rank_expert_parallel_step_is_the_one_rank_step(train_runs):
    two, _, (params, hist, dropped), _ = train_runs
    assert dropped == 0
    for got in two:
        assert int(got["ep_dropped"][0]) == 0
        np.testing.assert_allclose(got["ep_hist"], hist, rtol=1e-6,
                                   atol=1e-6)
        for n, t in params.named_parameters():
            np.testing.assert_allclose(got["ep_p." + n], t.detach().numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)
