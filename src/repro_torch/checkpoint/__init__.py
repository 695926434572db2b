"""Sharded async checkpointing with elastic restore."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
