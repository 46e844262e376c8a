"""The import guard: nothing a run executes may load JAX or the JAX package.

Top-level module names are compared whole: ``repro_torch`` (the port) begins
with ``repro`` (the JAX package), so a prefix test would be wrong.
"""
from __future__ import annotations

import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def jax_loaded(modules: Iterable[str] = None) -> Set[str]:
    """The forbidden top-level names among ``modules`` (default: the names
    in ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return {m.split(".", 1)[0] for m in names} & FORBIDDEN
