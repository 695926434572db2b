"""Optimizers and gradient compression."""
from . import compression
from .optimizers import (GradScale, Optimizer, adamw, apply_grad_scale,
                         clip_by_global_norm, global_norm, sgd)

__all__ = ["GradScale", "Optimizer", "adamw", "apply_grad_scale",
           "clip_by_global_norm", "compression", "global_norm", "sgd"]
