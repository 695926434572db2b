"""Optimizers and gradient compression."""
from . import compression
from .optimizers import Optimizer, adamw, clip_by_global_norm, global_norm, sgd

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "compression",
           "global_norm", "sgd"]
