"""repro_torch.corpus — constrained-random design corpus + conformance
sweep (PyTorch port of ``repro.corpus``).

A seeded generator of task-parallel dataflow Programs (10-1000 modules,
reproducible from ``(seed, scale)``) and the differential conformance
runner that pins every engine path — plus a sampled RTL oracle
cross-check — on the generated designs.  The engine paths are the
reference's, with its Pallas lane replaced by the port's ``"cuda"``
lane (the sparse max-plus CUDA kernel).
"""
from .builders import MOD, build_case, build_poll_case  # noqa: F401
from .conformance import (ENGINE_PATHS, ConformanceReport,  # noqa: F401
                          check_conformance, fifo_digest, result_record,
                          rtl_crosscheck)
from .generator import (CorpusCase, EDIT_KINDS, EditPair,  # noqa: F401
                        PATCHABLE_KINDS, edit_pairs, generate)
from .spec import (BENCH_SPEC, BLOCKING_SPEC, Choice,  # noqa: F401
                   CorpusSpec, DEFAULT_SPEC, IntRange)

__all__ = [
    "generate", "CorpusCase",
    "edit_pairs", "EditPair", "EDIT_KINDS", "PATCHABLE_KINDS",
    "CorpusSpec", "IntRange", "Choice",
    "DEFAULT_SPEC", "BLOCKING_SPEC", "BENCH_SPEC",
    "build_case", "build_poll_case", "MOD",
    "check_conformance", "ConformanceReport", "ENGINE_PATHS",
    "result_record", "fifo_digest", "rtl_crosscheck",
]
