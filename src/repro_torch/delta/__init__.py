"""repro_torch.delta — structural deltas: edit-and-resimulate as a served
workload (PyTorch port of ``repro.delta``).

The warm-cache architecture (``sweep/cache.py``) reuses work only on an
exact ``program_fingerprint`` match.  This package factors that key into a
per-module table (:mod:`~repro_torch.delta.fingerprint`), classifies design
edits (``diff -> DesignDelta``), patches recorded traces and compiled
graphs for body-only edits with a mandatory pointwise re-verification pass
(:mod:`~repro_torch.delta.patch`), and exposes the interactive loop as served
:class:`~repro_torch.delta.session.EditSession` handles
(``SweepService.edit_session``).

Soundness contract: a patched result is bit-identical to a cold run or it
is rejected to a cold rebuild — stale timing is never served.
"""
from .fingerprint import (ADDED, BODY_EDITED, INTERFACE_CHANGED, KEPT,
                          REMOVED, RENAMED, RETYPED, UNCHANGED,
                          DesignDelta, DesignFingerprint, ModuleFingerprint,
                          diff, fingerprint_design)
from .patch import (DeltaState, PatchOutcome, PatchReject, apply_patch,
                    cold_build, snapshot)
from .session import EditOutcome, EditSession

__all__ = [
    "UNCHANGED", "BODY_EDITED", "INTERFACE_CHANGED", "ADDED", "REMOVED",
    "KEPT", "RETYPED", "RENAMED",
    "ModuleFingerprint", "DesignFingerprint", "DesignDelta",
    "fingerprint_design", "diff",
    "DeltaState", "PatchOutcome", "PatchReject",
    "snapshot", "apply_patch", "cold_build",
    "EditOutcome", "EditSession",
]
