"""Core: the paper's contribution in PyTorch (port of ``repro.core``).

Expression IR (CTE graph) + Algorithm-1 reverse-mode autodiff + two
execution engines — relational (SQL-92, COO join/group-by) and dense
(array data type) — plus the recursive-CTE iteration construct.  The SQL
transpiler (``sqlgen``) arrives with the in-database tier.
"""
from . import autodiff, dense, expr, nn2sql, rel_engine, relational
from .engine import Engine, sgd_step_fn
from .recursive_cte import history_bytes, recursive_cte, recursive_cte_py
from .relational import RelTensor, one_hot, one_hot_dense

__all__ = [
    "autodiff", "dense", "expr", "nn2sql", "rel_engine", "relational",
    "Engine", "sgd_step_fn", "recursive_cte", "recursive_cte_py",
    "history_bytes", "RelTensor", "one_hot", "one_hot_dense",
]
