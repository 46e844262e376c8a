"""Benchmark design registry: the paper's Type B/C designs, the Type A
suite, and dynamic (query-sparse Type B/C) designs beyond the paper —
the PyTorch port's copy of ``repro.designs``."""
from .dynamic import DYNAMIC_DESIGNS
from .paper import PAPER_DESIGNS
from .typea import TYPEA_DESIGNS

ALL_DESIGNS = {**PAPER_DESIGNS, **TYPEA_DESIGNS, **DYNAMIC_DESIGNS}

__all__ = ["PAPER_DESIGNS", "TYPEA_DESIGNS", "DYNAMIC_DESIGNS", "ALL_DESIGNS"]
