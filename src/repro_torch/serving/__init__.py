"""Batched serving engine with continuous batching, and the micro-batching
request front over the in-database engines."""
from .db_serve import SQLBatchServer
from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine", "SQLBatchServer"]
