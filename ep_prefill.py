#!/usr/bin/env python3
"""Expert-parallel prefill over several processes, one card each.

Usage, from the repository root on a machine with N cards::

    torchrun --nproc-per-node 4 ep_prefill.py
    torchrun --nproc-per-node 4 ep_prefill.py --smoke --device cpu   # gloo

Each process joins the job's process group (NCCL on the card, gloo with
``--device cpu``) and a ``(1, N)`` mesh ``("data", "model")``: every rank
holds its ``E_pad / N`` experts of every MoE layer (``init_params(...,
mesh=)``) and the dense layers whole, and the prefill step takes
``moe_ep`` over 'model' (each rank its sequence chunk, NCCL's
all-to-all, the output gathered).  Two phases, each printing its line:

  1. agreement: one MoE layer held whole on every rank, ``moe_ep`` over
     the N ranks at dropless capacity (E_pad / top_k) on this rank's
     chunk of a seeded float32 input against ``moe_dense`` on the whole
     input on this rank, within 1e-5 of the output's scale;
  2. the prefill step of qwen3-moe-30b-a3b at its published widths and
     full depth (48 layers; ``--smoke``: its smoke config) on B 2 x S 2048
     seeded tokens in bf16, through ``moe_ep`` at capacity 1.25: the
     first call's wall time, the median of 3 (host clock to a device
     sync, every rank starting together), peak device
     memory, the top-k choices dropped, and the logits' agreement across
     ranks (the output is replicated: every rank must hold the same, up
     to 1e-2 in bf16).

Rank 0 prints the card's name and power limit and, last, one JSON line
with the numbers.  Any failure exits non-zero.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH, BATCH, SEQ = "qwen3-moe-30b-a3b", 2, 2048


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.distrib.sharding import mesh_axes, set_active_mesh
    from repro_torch.kernels._cuda import resolve_device
    from repro_torch.launch.mesh import device_type, init_process_group
    from repro_torch.models import api, moe
    from repro_torch.train.step import make_prefill_step

    if "WORLD_SIZE" not in os.environ:
        print("ep_prefill: run it under torchrun", file=sys.stderr)
        return 1
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    init_process_group(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device_type(), (1, world),
                            mesh_dim_names=("data", "model"))
    say = print if rank == 0 else (lambda *a, **k: None)
    card = "cpu"
    if dev.type == "cuda" and rank == 0:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = get_arch(ARCH)
    if args.smoke:
        cfg = cfg.smoke()
    result = {"arch": cfg.name, "layers": cfg.num_layers, "world": world,
              "mesh": mesh_axes(mesh), "batch": BATCH, "seq": SEQ}
    failed = []
    say(f"mesh {mesh_axes(mesh)} over {world} processes "
        f"({dist.get_backend()}) [{card}]")

    # 1. agreement on one layer held whole, f32, dropless
    try:
        layer = moe.MoE(cfg, device=dev).reset_parameters(
            torch.Generator(device=dev).manual_seed(1))
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (1, 64 * world, cfg.d_model)).astype(np.float32)).to(dev)
        E, K = layer.router.shape[-1], cfg.moe.top_k
        with torch.no_grad():
            xs = moe.seq_split(x, mesh)
            with moe.count_drops() as d:
                got = moe.moe_ep(layer, xs, cfg, mesh, capacity_factor=E / K)
            want = moe.moe_dense(layer, x, cfg)
            s = xs.shape[1]
            want = want[:, rank * s:(rank + 1) * s]
        err = (got - want).abs().max().item()
        lim = 1e-5 * max(1.0, want.abs().max().item())
        ok = err <= lim and d["dropped"] == 0
        errs = [None] * world
        dist.all_gather_object(errs, err)
        result["agree_f32"] = max(errs)
        say(f"1. moe_ep over {world} ranks at capacity {E // K} against "
            f"moe_dense, float32: max abs diff over ranks {max(errs):.3g} "
            f"(limit {lim:.3g}), dropped {d['dropped']}")
        if not ok:
            failed.append("agreement")
        del layer, x, xs, got, want
    except Exception as e:                 # noqa: BLE001 — report, go on
        failed.append(f"agreement: {e!r}")

    # 2. the prefill at depth through moe_ep, experts sharded
    try:
        t0 = time.perf_counter()
        params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev, mesh=mesh)
        sync()
        n_par = sum(p.numel() for p in params.parameters())
        held = params.layers[0].moe.w_gate.shape[0]
        result.update(params_per_rank=n_par, experts_per_rank=held,
                      init_s=time.perf_counter() - t0)
        say(f"   {cfg.name}: {cfg.num_layers} layers, {held} of "
            f"{params.layers[0].moe.router.shape[-1]} experts a rank, "
            f"{n_par} parameters a rank (init "
            f"{result['init_s']:.2f} s)")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (BATCH, SEQ))).to(dev)
        prefill = make_prefill_step(cfg)
        set_active_mesh(mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        with moe.count_drops() as d:
            logits = prefill(params, {"tokens": toks})
            sync()
        result["first_s"] = time.perf_counter() - t0
        ms = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            prefill(params, {"tokens": toks})
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        set_active_mesh(None)
        result["prefill_ms"] = statistics.median(ms)
        if dev.type == "cuda":
            result["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        drops = torch.tensor([d["dropped"], d["choices"]], dtype=torch.int64,
                             device=dev)
        dist.all_reduce(drops)
        result["dropped"] = drops[0].item() / drops[1].item()
        lg = logits.float()
        same = lg.clone()
        dist.broadcast(same, 0)
        spread = (lg - same).abs().max()
        dist.all_reduce(spread, op=dist.ReduceOp.MAX)
        result["logits_spread"] = spread.item()
        finite = bool(torch.isfinite(lg).all())
        say(f"2. prefill B={BATCH} S={SEQ} {cfg.dtype}: first "
            f"call {result['first_s']:.3f} s, median of 3 "
            f"{result['prefill_ms']:.3f} ms (host clock to a sync); peak "
            f"{result.get('peak_gib', 0):.3f} GiB on rank 0; top-"
            f"{cfg.moe.top_k} choices dropped at capacity 1.25 "
            f"{100 * result['dropped']:.3f} %; logits finite {finite}, "
            f"largest difference between ranks {result['logits_spread']:.3g}"
            f" [{card}]")
        # the output is replicated: the ranks run the same dense layers on
        # the same gathered MoE outputs
        if not finite or result["logits_spread"] > 1e-2:
            failed.append("prefill")
    except Exception as e:                 # noqa: BLE001 — report, go on
        failed.append(f"prefill: {e!r}")

    dist.destroy_process_group()
    if failed:
        print(f"rank {rank} FAILED: {failed}", file=sys.stderr)
        return 1
    say(card)
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
