"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig
from .internvl2_1b import CONFIG as INTERNVL2_1B
from .qwen2_5_14b import CONFIG as QWEN2_5_14B
from .gemma2_2b import CONFIG as GEMMA2_2B
from .smollm_135m import CONFIG as SMOLLM_135M
from .minicpm_2b import CONFIG as MINICPM_2B
from .hymba_1_5b import CONFIG as HYMBA_1_5B
from .qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M
from .seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from .xlstm_1_3b import CONFIG as XLSTM_1_3B

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        INTERNVL2_1B, QWEN2_5_14B, GEMMA2_2B, SMOLLM_135M, MINICPM_2B,
        HYMBA_1_5B, QWEN3_MOE_30B_A3B, GRANITE_MOE_3B_A800M,
        SEAMLESS_M4T_MEDIUM, XLSTM_1_3B,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]
