"""Training launcher: ``python -m repro_torch.launch.train --arch
smollm-135m`` (``--smoke`` for the reduced config, ``--device cpu`` for
the plain versions on a machine without a card); several processes with
``torchrun --nproc-per-node N -m repro_torch.launch.train ...``.

The port of ``repro.launch.train``: the reference's flags and its loop.

  * the mesh, as the reference installs it: ``launch.mesh.make_host_mesh()``
    ((world, 1) ``("data", "model")``) under ``--smoke`` or with fewer than
    16 ranks, else ``distrib.elastic.make_elastic_mesh()``; it becomes the
    active mesh for the run (the MoE families take ``moe_ep`` over
    'model', at n = 1 on the host mesh).  The process group is NCCL on the
    card and gloo on the CPU: ``torchrun``'s, or one of a single process
    that the launcher starts and ends;
  * the reference's ``device_put`` of the parameters and the AdamW state
    under ``shardings_for(mesh, param_specs(...))``
    (``distrib.sharding.device_put``): each leaf becomes a DTensor and a
    rank holds only its shard.  On the host mesh (n, 1) that is FSDP over
    'data' for every leaf whose stacked size reaches the FSDP threshold
    (the rest replicated, as their specs say); over 'model' it is the
    tensor-parallel and expert split;
  * data parallelism: each 'data' rank takes its rows of the global batch
    (``batch_spec``) as its shard of a DTensor batch; DTensor reduces the
    gradients over the DP axes and the clip sums every shard once
    (``train.step``); only rank 0 writes checkpoints, which hold every
    leaf whole (gathered on every rank) and are cut back into shards on
    restore;
  * the data stream is the reference's (``data.pipeline``): batch i is a
    pure function of (seed, i, host), so a restart resumes it exactly;
  * auto-restart: resumes from the latest complete checkpoint (atomic,
    versioned: ``distrib.checkpoint``) including the data-iterator state;
  * straggler monitor hook (per-step wall time EWMA,
    ``distrib.elastic.StragglerMonitor``);
  * optional int8 error-feedback gradient compression.

Weights are drawn from ``--seed`` on the training device.  ``main``
returns what a caller checks: the step it started from, each step's
metrics (floats) and wall time, the parameters, the AdamW state and the
data-iterator state.  The default device is ``cuda``, which raises
without a card.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..data.pipeline import DataConfig, SyntheticTokenStream
from ..distrib.checkpoint import CheckpointManager
from ..distrib.elastic import StragglerMonitor, make_elastic_mesh
from ..distrib.sharding import (FSDP_MIN_ELEMS, active_mesh, batch_spec,
                                device_put, is_dtensor, local_slice,
                                mesh_axes, param_specs, placements,
                                set_active_mesh, shardings_for)
from ..kernels._cuda import resolve_device
from ..models import api
from ..optim.adamw import init_adamw
from ..train.step import make_train_step
from .mesh import init_process_group, make_host_mesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU hosts")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 error-feedback gradient compression (DP "
                         "bandwidth reduction demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    started = init_process_group(device)
    before = active_mesh()
    try:
        return _run(args, cfg, device)
    finally:
        set_active_mesh(before)
        if started:
            dist.destroy_process_group()


def _run(args, cfg, device: torch.device) -> Dict[str, Any]:
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_host_mesh() if args.smoke or world < 16 \
        else make_elastic_mesh()
    set_active_mesh(mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh_axes(mesh)} on {device} ({world} processes)")

    data = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model))
    # this rank's rows of the global batch (the reference's batch_spec)
    bspec = batch_spec(mesh, 2, batch_size=args.batch)
    rows = local_slice(mesh, bspec[0], args.batch)

    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name))
    params = api.init_params(torch.Generator(device=device)
                             .manual_seed(args.seed), cfg, device=device)
    # the reference's device_put: parameters, then the AdamW state made
    # from them, as DTensors under their specs.  When no leaf's spec
    # splits it on this mesh (one process, or a model whose every leaf is
    # under the FSDP threshold on (n, 1)) every rank holds every leaf
    # whole either way, and the leaves stay plain tensors (the gradients
    # are then averaged over the DP group by train.step.reduce_gradients)
    shardings = shardings_for(mesh, param_specs(params, FSDP_MIN_ELEMS))
    if any(not p.is_replicate() and n > 1 for sh in shardings.values()
           for p, n in zip(sh.placements, mesh.shape)):
        params = device_put(params, shardings)
        say("parameters and AdamW state: DTensors under their specs")
    opt_state = init_adamw(params)
    start_step = 0
    latest = ckpt.latest()
    if latest is not None:
        params, opt_state, extra = ckpt.restore(latest, params, opt_state)
        data.restore(extra["data"])
        start_step = latest
        say(f"restored checkpoint step {latest}")

    step_fn = make_train_step(cfg, total_steps=args.steps, peak_lr=args.lr,
                              grad_compression=args.grad_compression)
    monitor = StragglerMonitor()

    history: List[Dict[str, float]] = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v[rows]).to(device)
                 for k, v in data.next_batch().items()}
        if is_dtensor(params.embed):
            batch = {k: _shard_of(v, mesh, args.batch)
                     for k, v in batch.items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(device)
        dt = time.time() - t0
        history.append({"step": step + 1, **metrics, "seconds": dt})
        monitor.record(0, dt)
        if (step + 1) % args.log_every == 0:
            say(f"step {step+1:6d} loss={metrics['loss']:.4f} "
                f"gnorm={metrics['grad_norm']:.3f} "
                f"lr={metrics['lr']:.2e} {dt*1e3:.0f}ms", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            # every rank gathers the leaves; rank 0 writes them
            path = ckpt.save(step + 1, params, opt_state,
                             extra={"data": data.state()}, write=rank == 0)
            say(f"checkpoint -> {path}")
            if world > 1:
                dist.barrier()
        if monitor.stragglers():
            say("straggler detected; in production this host is evicted "
                "and the elastic re-mesh path rebalances the fleet")
    total = time.time() - t_start
    say(f"done: {args.steps - start_step} steps in {total:.1f}s")
    return {"start_step": start_step, "history": history, "params": params,
            "opt_state": opt_state, "data_state": data.state(), "cfg": cfg,
            "mesh": mesh_axes(mesh), "rows": rows}


def _shard_of(local: torch.Tensor, mesh, global_batch: int):
    """This rank's rows of a batch array as its shard of a DTensor whose
    dim 0 is split by ``batch_spec``."""
    from torch.distributed.tensor import DTensor

    spec = batch_spec(mesh, local.dim(), batch_size=global_batch)
    shape = (global_batch, *local.shape[1:])
    stride, step = [], 1
    for n in reversed(shape):
        stride.insert(0, step)
        step *= n
    return DTensor.from_local(local.contiguous(), mesh,
                              placements(mesh, spec), run_check=False,
                              shape=shape, stride=tuple(stride))


if __name__ == "__main__":
    main()
