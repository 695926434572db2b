"""Batched serving engine with continuous batching."""
from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
