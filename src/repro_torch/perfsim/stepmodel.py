"""Bridge: dry-run roofline records -> pipeline dataflow specs.

The PyTorch port's copy of ``repro.perfsim.stepmodel``: it reads the
dry-run JSON records that the port's own ``launch/dryrun.py`` writes
(``python -m repro_torch.launch.dryrun``, default ``--out
reports/dryrun``; the reference's records have the same keys but
``memory.fits_16gb_hbm``), so it needs neither JAX nor a card.

Takes the per-cell roofline terms produced by ``launch/dryrun.py`` and
derives tick costs for a hypothetical pipeline-parallel deployment of the
same model (stages split layers; microbatches split the global batch), so
``perfsim.pipeline`` can predict step time and sweep schedules before any
hardware run — the OmniSim use case transplanted to distributed training.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

from .pipeline import PipelineSpec

TICK_US = 1.0        # one simulation cycle == 1 microsecond


def spec_from_roofline(record: Dict, stages: int = 8, microbatches: int = 32,
                       buffer_depth: int = 2, schedule: str = "1f1b"
                       ) -> PipelineSpec:
    """record: one dry-run JSON (launch/dryrun.py).  The cell's dominant-term
    step time is split: forward = 1/3 compute, backward = 2/3 (standard
    fwd:bwd FLOP ratio); per-stage per-microbatch ticks follow."""
    roof = record["roofline"]
    step_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    total_ticks = step_s * 1e6 / TICK_US
    per_mb_stage = max(1, int(round(total_ticks / (stages * microbatches))))
    fwd = max(1, per_mb_stage // 3)
    bwd = max(1, per_mb_stage - fwd)
    coll = int(roof["collective_s"] * 1e6 / TICK_US / stages)
    return PipelineSpec(stages=stages, microbatches=microbatches,
                        fwd_ticks=fwd, bwd_ticks=bwd, p2p_ticks=1,
                        buffer_depth=buffer_depth, schedule=schedule,
                        dp_allreduce_ticks=max(0, coll))


def load_record(out_dir: str, arch: str, shape: str,
                mesh: str = "sp") -> Optional[Dict]:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
