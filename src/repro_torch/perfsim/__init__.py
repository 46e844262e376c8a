"""perfsim: OmniSim as a distributed-schedule simulator (the PyTorch
port's copy of ``repro.perfsim``; host code)."""
from .pipeline import (PipelineResult, PipelineSpec, buffer_depth_dse,
                       build_pipeline_program, simulate_pipeline)
from .stepmodel import TICK_US, load_record, spec_from_roofline

__all__ = ["PipelineSpec", "PipelineResult", "build_pipeline_program",
           "simulate_pipeline", "buffer_depth_dse", "spec_from_roofline",
           "load_record", "TICK_US"]
