"""Nested trees of tensors (dicts, tuples, lists), walked in JAX's leaf
order: dict keys sorted at each level, tuples and lists in order.  So leaf
i of a tree names the same tensor as ``jax.tree.leaves(...)[i]`` of the
JAX package's tree, which is what lets a checkpoint, an optimiser state or
a gradient cross between the two packages leaf by leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterable


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(example, values: Iterable) -> Any:
    """A tree shaped as ``example`` whose leaves, in JAX's order, are
    ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(example)
    if next(it, None) is not None:
        raise ValueError("more values than the example has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``,
    keeping the structure."""
    return unflatten(tree, map(fn, leaves(tree), *map(leaves, rest)))
