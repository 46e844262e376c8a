"""Max-plus longest-path kernels: the sparse chain-structured fixpoint
(``sparse``, kernel 1) and the dense sweep (``kernel``, kernel 2), with
their plain PyTorch versions (``ref``) and dispatchers (``ops``)."""
from .kernel import maxplus_sweep
from .ops import finalize_times, longest_path
from .sparse import solve_chains

__all__ = ["maxplus_sweep", "longest_path", "finalize_times", "solve_chains"]
