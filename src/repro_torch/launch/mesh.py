"""Mesh construction over the process group.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
one process per device.  The constructors are FUNCTIONS, not module-level
constants: importing this module touches no device and starts no process
group.  :func:`init_process_group` starts one when the caller asks (NCCL
for a CUDA device, gloo for the CPU; the card never falls back to gloo).
"""
from __future__ import annotations

import os

import torch


def init_process_group(device) -> bool:
    """Start the default process group for ``device`` unless one is
    running: NCCL for a CUDA device, gloo for the CPU.  Under ``torchrun``
    (``RANK`` and ``WORLD_SIZE`` in the environment) it joins that job's
    group; otherwise it starts a group of one process over a TCP store on
    a free localhost port.  Returns True when it started one (the caller
    ends it with ``torch.distributed.destroy_process_group()``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


def device_type() -> str:
    """The mesh's device type: ``"cuda"`` under NCCL, else ``"cpu"``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first "
                           "(init_process_group(device), or torchrun)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type(), tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 processes) or 2x16x16 multi-pod (512)."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    device_type()
    if dist.get_world_size() != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} "
                           f"processes, the group has "
                           f"{dist.get_world_size()}")
    return _mesh(shape, axes)


def make_host_mesh():
    """(world, 1) ``("data", "model")`` over the process group: (1, 1)
    with one process."""
    import torch.distributed as dist

    device_type()
    return _mesh((dist.get_world_size(), 1), ("data", "model"))
