"""Elastic scaling + straggler mitigation.

The port of ``repro.distrib.elastic``.  ``best_mesh_shape`` is the
reference's rule for the largest usable (pod, data, model) shape of a
surviving device count: 'model' is pinned, 'data' shrinks, full pods are
preferred.  ``make_elastic_mesh`` builds that shape as a ``DeviceMesh``
over the first ``prod(shape)`` ranks of the process group (one process
per device); the training launcher takes it with 16 ranks or more.  ``StragglerMonitor`` keeps an EWMA of per-host step time and
reports a host that exceeds ``straggler_factor`` x the fleet median for
``patience`` consecutive checks; the train launcher feeds it each step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def best_mesh_shape(n_devices: int, model_parallel: int = 16,
                    pod_size: int = 256) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable (pod, data, model) shape for a surviving device count.

    'model' is pinned (changing it re-lays-out every weight shard); 'data'
    shrinks to the largest multiple that fits; full pods are preferred.
    """
    assert n_devices >= model_parallel, "fewer devices than model shards"
    pods = n_devices // pod_size
    if pods >= 2:
        data = pod_size // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    data = n_devices // model_parallel
    return (data, model_parallel), ("data", "model")


def make_elastic_mesh(n_devices: Optional[int] = None,
                      model_parallel: int = 16):
    """:func:`best_mesh_shape` of ``n_devices`` (default: the process
    group's world size) as a ``DeviceMesh`` over ranks ``0 ..
    prod(shape) - 1``; every rank calls it, and a rank left out holds no
    coordinate."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import device_type

    kind = device_type()
    n = n_devices or dist.get_world_size()
    shape, axes = best_mesh_shape(n, model_parallel)
    used = int(np.prod(shape))
    return DeviceMesh(kind, torch.arange(used).reshape(shape),
                      mesh_dim_names=axes)


@dataclass
class StragglerMonitor:
    straggler_factor: float = 1.5
    patience: int = 5
    ewma: Dict[int, float] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=dict)

    def record(self, host_id: int, step_time_s: float) -> None:
        prev = self.ewma.get(host_id, step_time_s)
        self.ewma[host_id] = 0.8 * prev + 0.2 * step_time_s

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        median = float(np.median(list(self.ewma.values())))
        out = []
        for h, t in self.ewma.items():
            if t > self.straggler_factor * median:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                if self.strikes[h] >= self.patience:
                    out.append(h)
            else:
                self.strikes[h] = 0
        return out
