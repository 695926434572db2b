"""The LM stack of the port: ``layers`` (norms, rope, MLPs, GQA attention)
and ``model.LM`` for the dense, vlm and audio families."""
from .model import LM

__all__ = ["LM"]
