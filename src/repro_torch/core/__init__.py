"""OmniSim core, PyTorch port: coupled functionality + performance
simulation of dataflow hardware designs (Sarkar & Hao, MICRO'25).

Mirrors ``repro.core``'s public names for what is ported so far::

    from repro_torch.core import (Program, Read, Write, ReadNB, WriteNB,
                                  Empty, Full, Delay, Emit, simulate,
                                  simulate_rtl, simulate_traced,
                                  LightningSim, csim, resimulate,
                                  resimulate_batch, classify,
                                  program_fingerprint)

The simulator is host logic (plain Python and numpy, following the
reference): the generator engine, trace-compiled replay, the RTL oracle,
the LightningSim baseline, C-sim and the taxonomy.  The batched depth
re-solve (``resimulate_batch``) runs its max-plus fixpoint on the card
through hand-written CUDA kernels (``repro_torch.kernels.maxplus``).  Not
ported yet: the hybrid replay (``HybridCache``, ``HybridSim``,
``simulate_hybrid``; ROADMAP queue 1, item 5).
"""
from .dse import BatchOutcome, resimulate_batch, solve_block_status
from .engine import OmniSim, simulate
from .events import (Constraint, DeadlockError, NodeKind, Query, RequestType,
                     SimStats, UnsupportedDesignError)
from .graph import (ChainFlatArrays, SimGraph, export_chain_flat,
                    level_schedule, longest_path_chains,
                    longest_path_chains_batched, longest_path_numpy,
                    to_dense_blocks)
from .incremental import (CompiledGraph, IncrementalOutcome,
                          check_constraints, compile_graph,
                          compiled_graph_from_arrays, resimulate,
                          verify_times)
from .lightningsim import CSimCrash, LightningSim, csim
from .program import (Delay, Emit, Empty, Fifo, Full, Module, Op, Program,
                      Read, ReadNB, SimResult, Write, WriteNB)
from .rtlsim import simulate_rtl
from .taxonomy import Classification, classify, classify_dynamic
from .trace import (CompiledTrace, ModuleTrace, RecordedTrace, TraceSimGraph,
                    TraceUnsupported, compile_trace, module_content_hash,
                    program_fingerprint, record_trace, simulate_traced)

__all__ = [
    "OmniSim", "simulate", "resimulate", "resimulate_batch",
    "solve_block_status", "BatchOutcome", "CompiledGraph", "compile_graph",
    "compiled_graph_from_arrays", "check_constraints", "verify_times",
    "IncrementalOutcome", "Program", "Fifo", "Module", "Op", "Read", "Write",
    "ReadNB", "WriteNB", "Empty", "Full", "Delay", "Emit", "SimResult",
    "SimGraph", "longest_path_numpy", "longest_path_chains",
    "longest_path_chains_batched", "level_schedule", "to_dense_blocks",
    "ChainFlatArrays", "export_chain_flat", "Constraint", "DeadlockError",
    "Query", "RequestType", "NodeKind", "SimStats", "UnsupportedDesignError",
    "program_fingerprint", "module_content_hash", "simulate_rtl",
    "LightningSim", "csim", "CSimCrash", "classify", "classify_dynamic",
    "Classification", "TraceUnsupported", "RecordedTrace", "ModuleTrace",
    "CompiledTrace", "TraceSimGraph", "record_trace", "compile_trace",
    "simulate_traced",
]
