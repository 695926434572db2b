"""Architecture configs: one module per assigned arch + the paper's MLPs."""
from .base import ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, get_config, shape_applicable

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config",
           "shape_applicable"]
