"""OmniSim applied to distributed training schedules — the paper's technique
as a first-class framework feature.

The PyTorch port's copy of ``repro.perfsim.pipeline`` (host code: it
imports none of the reference, only the port's ``core``).  Like the
reference, ``buffer_depth_dse`` re-solves through ``core.incremental
.resimulate`` on the host; it has no device lane.

A pipeline-parallel training step IS a dataflow design: stages are modules,
the activation/grad queues between them are finite-depth FIFOs, microbatches
are tokens flowing through.  GPipe and 1F1B are just different module bodies.
The OmniSim engine then gives, *for free*:

  * cycle-accurate step-time prediction (ticks = microseconds here),
  * deadlock detection for under-provisioned buffer depths — the classic
    pipeline-schedule bug, caught by the engine instead of a hung job,
  * incremental re-simulation over buffer depths (paper Sec. 7.2): schedule
    DSE sweeps depths in microseconds instead of re-simulating each point,
  * bubble-fraction accounting from the simulation graph.

Tick costs come from the dry-run roofline terms (the port's
``launch/dryrun.py`` records, priced by ``launch/roofline.py``):
per-stage forward/backward compute ticks and inter-stage P2P ticks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.engine import simulate
from ..core.incremental import IncrementalOutcome, resimulate
from ..core.program import Delay, Emit, Program, Read, Write
from ..core.rtlsim import simulate_rtl


@dataclass
class PipelineSpec:
    stages: int
    microbatches: int
    fwd_ticks: int                  # per-stage per-microbatch forward time
    bwd_ticks: int                  # per-stage per-microbatch backward time
    p2p_ticks: int = 1              # inter-stage activation/grad transfer
    buffer_depth: int = 2           # activation queue slots between stages
    schedule: str = "1f1b"          # "gpipe" | "1f1b"
    dp_allreduce_ticks: int = 0     # overlapped DP gradient all-reduce


def build_pipeline_program(spec: PipelineSpec) -> Program:
    """Construct the dataflow program for a pipeline schedule."""
    prog = Program(f"pipeline_{spec.schedule}_{spec.stages}s_{spec.microbatches}mb",
                   declared_type="B")
    S, M = spec.stages, spec.microbatches
    # FIFOs: forward activations fwd[i] from stage i -> i+1;
    #        backward grads bwd[i] from stage i+1 -> i.
    fwd = [prog.fifo(f"act{i}", spec.buffer_depth) for i in range(S - 1)]
    bwd = [prog.fifo(f"grad{i}", spec.buffer_depth) for i in range(S - 1)]
    grads_out = prog.fifo("grads_out", M)   # per-microbatch grad chunks to DP

    def make_stage(i: int):
        first, last = i == 0, i == S - 1

        def gpipe():
            # all forwards, then all backwards
            for m in range(M):
                if not first:
                    yield Read(fwd[i - 1])
                yield Delay(spec.fwd_ticks)
                if not last:
                    yield Delay(spec.p2p_ticks)
                    yield Write(fwd[i], ("a", m))
            for m in range(M):
                if not last:
                    yield Read(bwd[i])
                yield Delay(spec.bwd_ticks)
                if not first:
                    yield Delay(spec.p2p_ticks)
                    yield Write(bwd[i - 1], ("g", m))
            if first:
                yield Write(grads_out, i)
            yield Emit(f"stage{i}_done", True)

        def one_f_one_b():
            # warmup forwards = stages - i - 1, then steady 1F1B
            warmup = min(S - 1 - i, M)
            done_f = done_b = 0
            for _ in range(warmup):
                if not first:
                    yield Read(fwd[i - 1])
                yield Delay(spec.fwd_ticks)
                done_f += 1
                if not last:
                    yield Delay(spec.p2p_ticks)
                    yield Write(fwd[i], ("a", done_f))
            while done_b < M:
                if done_f < M:
                    if not first:
                        yield Read(fwd[i - 1])
                    yield Delay(spec.fwd_ticks)
                    done_f += 1
                    if not last:
                        yield Delay(spec.p2p_ticks)
                        yield Write(fwd[i], ("a", done_f))
                if not last:
                    yield Read(bwd[i])
                yield Delay(spec.bwd_ticks)
                done_b += 1
                if not first:
                    yield Delay(spec.p2p_ticks)
                    yield Write(bwd[i - 1], ("g", done_b))
            if first:
                yield Write(grads_out, i)
            yield Emit(f"stage{i}_done", True)

        return one_f_one_b if spec.schedule == "1f1b" else gpipe

    for i in range(S):
        prog.add_module(f"stage{i}", make_stage(i))

    # DP gradient all-reduce, overlapped: starts when the first stage
    # finishes its grads; a Type B consumer of the grads_out channel.
    if spec.dp_allreduce_ticks:
        @prog.module("dp_allreduce")
        def dp_allreduce():
            yield Read(grads_out)
            yield Delay(spec.dp_allreduce_ticks)
            yield Emit("allreduce_done", True)
    else:
        @prog.module("dp_sink")
        def dp_sink():
            yield Read(grads_out)

    return prog


@dataclass
class PipelineResult:
    step_ticks: int
    bubble_fraction: float
    deadlock: bool
    result: object


def simulate_pipeline(spec: PipelineSpec, engine: str = "omnisim"
                      ) -> PipelineResult:
    prog = build_pipeline_program(spec)
    res = simulate(prog) if engine == "omnisim" else simulate_rtl(prog)
    ideal = spec.microbatches * (spec.fwd_ticks + spec.bwd_ticks) \
        + (spec.stages - 1) * (spec.fwd_ticks + spec.bwd_ticks + 2 * spec.p2p_ticks)
    busy = spec.microbatches * (spec.fwd_ticks + spec.bwd_ticks)
    bubble = 1.0 - busy / res.cycles if res.cycles and not res.deadlock else 1.0
    return PipelineResult(step_ticks=res.cycles, bubble_fraction=bubble,
                          deadlock=res.deadlock, result=res)


def buffer_depth_dse(spec: PipelineSpec, depths: List[int]
                     ) -> List[Tuple[int, PipelineResult, Optional[float]]]:
    """FIFO-sizing DSE via incremental re-simulation (paper Sec. 7.2/Table 6
    retargeted at pipeline buffers).  Returns (depth, result, incr_time_s)."""
    base_spec = dataclasses.replace(spec, buffer_depth=depths[0])
    base = simulate_pipeline(base_spec)
    out = [(depths[0], base, None)]
    for d in depths[1:]:
        n_chan = 2 * (spec.stages - 1)
        new_depths = tuple([d] * n_chan + [spec.microbatches])
        inc = resimulate(base.result, new_depths)
        res = inc.result
        busy = spec.microbatches * (spec.fwd_ticks + spec.bwd_ticks)
        bubble = 1.0 - busy / res.cycles if res.cycles and not res.deadlock else 1.0
        out.append((d, PipelineResult(res.cycles, bubble, res.deadlock, res),
                    inc.elapsed_s if inc.ok else -inc.elapsed_s))
    return out
