"""Recursive CTE — the paper's iteration construct (PyTorch port of
``repro.core.recursive_cte``).

``WITH RECURSIVE w(iter, id, i, j, v) AS (base UNION ALL step)`` drives
gradient descent in Listings 1/7/10: the weight table is the recursion
variable, each recursion step emits the next weight version.  PyTorch runs
eagerly, so the recursion is a Python loop.

``materialize_history=False`` (default)
    Only the latest weight version stays referenced — the optimisation the
    paper's §8 asks database engines for ("optimisers should eliminate
    intermediate results within the CTE").

``materialize_history=True``
    Faithful UNION-ALL semantics: every iteration's weight table stays
    materialised (stacked along a leading ``iter`` axis), reproducing the
    paper's observation that "the recursive CTE grew with each iteration."
"""
from __future__ import annotations

from typing import Callable, TypeVar

import torch

T = TypeVar("T")


def _stack(states: list):
    """Stack a list of iterates (tensors, or dicts of them) along a new
    leading axis."""
    if isinstance(states[0], dict):
        return {k: _stack([s[k] for s in states]) for k in states[0]}
    return torch.stack(states)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def recursive_cte(base: T, step: Callable[[T, int], T], n_iters: int,
                  materialize_history: bool = False):
    """Iterate ``step`` starting from ``base``.

    Returns ``(final, history)``; ``history`` is ``None`` unless
    ``materialize_history`` — then it stacks every iterate (incl. base row 0)
    along axis 0, like ``select * from w order by iter``.
    """
    final, hist = recursive_cte_py(base, step, n_iters, materialize_history)
    return final, (_stack(hist) if materialize_history else None)


def recursive_cte_py(base: T, step: Callable[[T, int], T], n_iters: int,
                     materialize_history: bool = False):
    """The same recursion with the history kept as a list of iterates —
    the contract of the in-database backend's stepped strategy:
    ``(final, history)``, ``history`` includes the base iterate or is
    ``None``."""
    state = base
    hist = [base] if materialize_history else None
    for it in range(n_iters):
        state = step(state, it)
        if materialize_history:
            hist.append(state)
    return state, hist


def history_bytes(tree, n_iters: int) -> int:
    """Memory the UNION-ALL table reaches after ``n_iters`` recursions."""
    per_iter = sum(x.numel() * x.element_size() for x in _leaves(tree))
    return per_iter * (n_iters + 1)
