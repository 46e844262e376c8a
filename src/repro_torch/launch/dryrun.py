"""Multi-pod dry run: run every (architecture x input-shape) cell on the
production meshes with no card and no data, prove memory fits, and
extract roofline terms.

The port of ``repro.launch.dryrun``: the same CLI, ``run_cell``, cell tags
and record keys (``memory.fits_16gb_hbm`` becomes ``fits_80gb_hbm``).

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out reports/dryrun
    python -m repro_torch.launch.dryrun --all --mesh pod --roofline

Where the reference lowers and compiles each cell for 512 forced host
devices, the port runs it.  ``run_cell`` starts a fake process group of
256 (16x16) or 512 (2x16x16) ranks (``torch.distributed``'s ``"fake"``
backend: collectives do nothing, but every rank's layouts and the
collectives' shapes are real) and ends it in a ``finally``; nothing
happens at import.  Under a ``FakeTensorMode`` it builds the cell's
structures (``launch.specs.input_specs``), puts each under its sharding
(``distrib.sharding.device_put``: a rank holds only its shard, of shapes
alone), and calls the cell's real step function on those DTensors: the
train step (loss, backward, clip, AdamW in place) for train_4k, the
prefill step for prefill_32k, one decode step against a full cache for
decode_32k and long_500k.

Per cell the record holds the run's status and seconds (``compile_s``),
the memory of rank 0 (``args_gb``: the local shards of every argument;
``temp_gb``: the peak of everything else the step held, from
``torch.distributed._tools.mem_tracker.MemTracker``; ``out_gb`` and
``aliased_gb``: the results, and those that are arguments updated in
place; ``per_device_gb = args + temp``; ``fits_80gb_hbm``), the counted
cost (``raw_cost``: FLOPs and bytes of rank 0's local ops and its
collectives' bytes by kind, ``launch.roofline.CostCounter``; the
hand-written kernels, which launch nothing on fake tensors, count by the
formulas of their bounds, and their share stands under ``kernels``), and
the roofline terms at
H100 figures.  The port counts every layer and every chunk it runs, so
there is no depth extrapolation and ``chunk_scan_correction`` is zero.
One loop is too slow to run at full length under fake dispatch: the
sLSTM's time loop (xlstm-1.3b, 32 768 steps x 6 layers at prefill_32k):
for the run, one step stands in for ``models.xlstm._slstm_scan``,
counted S times in the forward and in the backward
(:func:`_slstm_one_step`), and the record says so under
``scaled_loops``; its memory is one step's.  A cell that fails is
``"FAILED"`` with its traceback, and the script exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import ARCHS, SHAPES, get_arch, shape_applicable
from ..configs.base import ArchConfig, ShapeCell
from ..distrib import sharding
from ..distrib.sharding import device_put, set_active_mesh
from .mesh import make_production_mesh
from .roofline import CostCounter, cost_of, model_flops, roofline_terms
from .specs import input_specs

HBM_PER_CHIP = 80e9          # H100 SXM (data sheet)

@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block; none is started if one runs already."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if sharding.is_dtensor(t) else t


def _local_bytes(tree) -> float:
    return float(sum(_local(t).numel() * t.element_size()
                     for t in _leaves(tree)))


def _leaves(tree):
    from torch import nn

    if isinstance(tree, nn.Module):
        return [p for p in tree.parameters()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


@contextlib.contextmanager
def _unseen_propagation():
    """DTensor derives each new op's global output shape by running the op
    on fake global-shape tensors under the active fake mode, where the
    counter and the memory tracker would take it for rank 0's work.  For
    the block, that derivation runs with every dispatch mode set aside
    (in a fake mode of its own)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _slstm_one_step(counter: CostCounter):
    """For the block, the sLSTM's time loop (``models.xlstm._slstm_scan``)
    runs its first step only and counts it S times (:class:`_OneStepForAll`)
    with ``counter``; yields the record ``{"slstm": {"steps": S, "run":
    1, "calls": n}}`` (empty when no sLSTM ran)."""
    from ..models import xlstm

    loops: Dict = {}

    def one_step(wx, r):
        B, S, H, P4 = wx.shape
        entry = loops.setdefault("slstm", {"steps": S, "run": 1,
                                           "calls": 0})
        entry["calls"] += 1
        h = _OneStepForAll.apply(wx[:, 0], r, S, counter)
        return h[:, None].expand(B, S, H, P4 // 4)

    saved, xlstm._slstm_scan = xlstm._slstm_scan, one_step
    try:
        yield loops
    finally:
        xlstm._slstm_scan = saved


def _first_step(wx_t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The sLSTM's first step from a zero state (``models.xlstm``)."""
    from ..models.xlstm import _slstm_cell

    B, H, P4 = wx_t.shape
    P = P4 // 4
    h, c, n = (wx_t.new_zeros(B, H, P) for _ in range(3))
    return _slstm_cell(wx_t + torch.einsum("bhp,hpq->bhq", h, r), c, n,
                       P)[0]


class _OneStepForAll(torch.autograd.Function):
    """One sLSTM step counted for ``S``: the forward and, in the backward,
    the step's recomputation and its vector-Jacobian product each count S
    times."""

    @staticmethod
    def forward(ctx, wx_t, r, S, counter):
        ctx.save_for_backward(wx_t, r)
        ctx.S, ctx.counter = S, counter
        with counter.scaled(S):
            return _first_step(wx_t, r)

    @staticmethod
    def backward(ctx, g):
        wx_t, r = ctx.saved_tensors
        with torch.enable_grad(), ctx.counter.scaled(ctx.S):
            a = wx_t.detach().requires_grad_()
            b = r.detach().requires_grad_()
            ga, gb = torch.autograd.grad(_first_step(a, b), (a, b), g)
        return ga, gb, None, None


def _count(cfg: ArchConfig, cell: ShapeCell, mesh) -> Dict:
    """Run the cell's step on fake DTensors and read what it cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    with _unseen_propagation(), FakeTensorMode():
        fn, args, in_sh, out_sh, _ = input_specs(cfg, cell, mesh,
                                                 device="cpu")
        args = tuple(device_put(a, s) for a, s in zip(args, in_sh))
        arg_bytes = _local_bytes(args)
        tracker = MemTracker()
        tracker.track_external(*[t for t in _leaves(args)])
        t0 = time.time()
        counter = CostCounter()
        with tracker, counter, _slstm_one_step(counter) as loops:
            out = fn(*args)
        seconds = time.time() - t0
        peak = max((snap.get("Total", 0) for snap in
                    tracker.get_tracker_snapshot("peak").values()),
                   default=0)
        out_bytes = _local_bytes(out)
        # results that are arguments updated in place (the same tensors)
        arg_ids = {id(_local(t)) for t in _leaves(args)}
        aliased = sum(_local(t).numel() * t.element_size()
                      for t in _leaves(out) if id(_local(t)) in arg_ids)
    return {"seconds": seconds, "counter": counter, "arg_bytes": arg_bytes,
            "temp_bytes": max(peak - arg_bytes, 0.0),
            "out_bytes": out_bytes, "aliased_bytes": float(aliased),
            "loops": loops}


def run_cell(arch: str, shape: str, multi_pod: bool,
             with_roofline: bool = True, cfg_overrides: Optional[Dict] = None
             ) -> Dict:
    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    cell = next(c for c in SHAPES if c.name == shape)
    ok, reason = shape_applicable(cfg, cell)
    rec: Dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    with fake_process_group(512 if multi_pod else 256):
        return _record(rec, cfg, cell,
                       lambda: make_production_mesh(multi_pod=multi_pod),
                       with_roofline and not multi_pod)


def run_config(cfg: ArchConfig, cell: ShapeCell, shape=(1, 1),
               axes=("data", "model")) -> Dict:
    """The dry run of any config and cell on a mesh of ``shape`` (a fake
    process group of ``prod(shape)`` ranks, started here if none runs):
    the record ``run_cell`` writes, roofline included.  At (1, 1) it is
    the roofline of one card running the whole step."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    rec: Dict = {"arch": cfg.name, "shape": cell.name,
                 "mesh": "x".join(map(str, shape))}
    with fake_process_group(math.prod(shape)):
        return _record(rec, cfg, cell, lambda: init_device_mesh(
            "cpu", tuple(shape), mesh_dim_names=tuple(axes)), True)


def _record(rec: Dict, cfg: ArchConfig, cell: ShapeCell, make_mesh,
            with_roofline: bool) -> Dict:
    saved_mesh, saved_tp = sharding.active_mesh(), sharding.tp_degree()
    try:
        mesh = make_mesh()
        chips = mesh.size()
        set_active_mesh(mesh)
        try:
            run = _count(cfg, cell, mesh)
        except Exception as e:      # a dry-run failure is a bug
            rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
            return rec
    finally:
        set_active_mesh(saved_mesh)
        sharding.set_tp_degree(saved_tp)
    counter = run["counter"]
    per_dev = run["arg_bytes"] + run["temp_bytes"]
    cost = cost_of(counter, run["temp_bytes"], run["arg_bytes"])
    rec.update(
        status="ok", chips=chips, compile_s=round(run["seconds"], 1),
        memory={
            "temp_gb": run["temp_bytes"] / 1e9,
            "args_gb": run["arg_bytes"] / 1e9,
            "out_gb": run["out_bytes"] / 1e9,
            "aliased_gb": run["aliased_bytes"] / 1e9,
            "per_device_gb": per_dev / 1e9,
            "fits_80gb_hbm": bool(per_dev <= HBM_PER_CHIP),
        },
        raw_cost={"flops": cost.flops,
                  "bytes_accessed": cost.bytes_accessed,
                  "collective_bytes": cost.coll_bytes,
                  "collectives": cost.coll_breakdown},
        kernels=counter.kernels,
    )
    if run["loops"]:
        rec["scaled_loops"] = run["loops"]
    if with_roofline:
        mf = model_flops(cfg, cell)
        roof = roofline_terms(cost, chips, mf)
        rec["chunk_scan_correction"] = {"flops": 0.0, "bytes": 0.0}
        rec["roofline"] = {
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "dominant": roof.dominant,
            "model_flops": mf,
            "hlo_flops_cluster": roof.hlo_flops,
            "useful_ratio": roof.useful_ratio,
            "dominant_fraction": roof.roofline_fraction,
            "collectives": cost.coll_breakdown,
        }
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, in this many worker processes")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = [c.name for c in SHAPES] if args.all or not args.shape \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    records = _run_cells(cells, args) if args.jobs > 1 else (
        _write(args.out, a, s, mp,
               run_cell(a, s, mp, with_roofline=not args.no_roofline))
        for a, s, mp in cells)
    failures = 0
    for tag, rec in records:
        status = rec["status"]
        failures += status == "FAILED"
        mem = rec.get("memory", {})
        roof = rec.get("roofline", {})
        print(f"{tag:55s} {status:8s} "
              f"mem={mem.get('per_device_gb', 0):6.2f}GB "
              f"dom={roof.get('dominant', '-'):10s} "
              f"compile={rec.get('compile_s', 0):5.1f}s", flush=True)
        if status == "FAILED":
            print("   ", rec.get("error"), flush=True)
    print(f"\n{'PASS' if failures == 0 else 'FAIL'}: {failures} failures")
    raise SystemExit(1 if failures else 0)


def _tag(arch: str, shape: str, mp: bool) -> str:
    return f"{arch}__{shape}__{'mp' if mp else 'sp'}"


def _write(out: str, arch: str, shape: str, mp: bool, rec: Dict):
    tag = _tag(arch, shape, mp)
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return tag, rec


def _run_cells(cells, args):
    """The cells over ``args.jobs`` worker processes (spawned; each runs
    cells one after another, its own fake process group for each), the
    train cells first; writes each record and yields (tag, record) in the
    cells' order.  A worker that dies fails its cell."""
    import concurrent.futures
    import multiprocessing

    order = {"train": 0, "prefill": 1, "decode": 2}
    kind = {c.name: c.kind for c in SHAPES}
    done = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as pool:
        futures = {pool.submit(run_cell, a, s, mp,
                               not args.no_roofline): (a, s, mp)
                   for a, s, mp in sorted(cells,
                                          key=lambda c: order[kind[c[1]]])}
        for fut in concurrent.futures.as_completed(futures):
            a, s, mp = futures[fut]
            try:
                rec = fut.result()
            except Exception as e:          # the worker died
                rec = {"arch": a, "shape": s,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAILED", "error": f"{type(e).__name__}: "
                                                    f"{e}",
                       "traceback": traceback.format_exc()[-2000:]}
            done[(a, s, mp)] = _write(args.out, a, s, mp, rec)
    for cell in cells:
        yield done[cell]


if __name__ == "__main__":
    main()
