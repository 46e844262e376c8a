"""Config system: architecture registry + shape cells."""
from .base import (ArchConfig, MoEConfig, SSMConfig, XLSTMConfig, ShapeCell,
                   SHAPES, shape_applicable)
from .registry import ARCHS, get_arch

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "XLSTMConfig", "ShapeCell",
           "SHAPES", "shape_applicable", "ARCHS", "get_arch"]
