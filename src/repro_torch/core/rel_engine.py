"""Relational (SQL-92) engine: evaluates the expression DAG over RelTensors
(PyTorch port of ``repro.core.rel_engine``).

Mirrors ``core.dense`` but every node is computed with the relational
building blocks of Listing 4 — each ``MatMul`` is the join + group-by of
``RelTensor.matmul`` (the ``relational_matmul`` kernel on the card).

The DAG-zoo tier (RowReduce/Softmax/ArgTopK/Gather/Scatter/RowShift/
Recurrence) evaluates through ``dense.eval_node`` on the densified children
and re-pivots the result — the relations stay canonical (dense cell set),
so the round trip is exact.
"""
from __future__ import annotations

import torch

from . import dense
from . import expr as E
from .autodiff import MapDeriv
from .relational import RelTensor


def evaluate(roots: list[E.Expr], env: dict[str, RelTensor],
             device="cuda") -> list[RelTensor]:
    device = torch.device(device)
    cache: dict[int, RelTensor] = {}

    def ev(node: E.Expr) -> RelTensor:
        if id(node) in cache:
            return cache[id(node)]
        if isinstance(node, E.Var):
            out = env[node.name]
            if not isinstance(out, RelTensor):
                raise TypeError(f"relational engine needs RelTensor for {node.name}")
        elif isinstance(node, E.Const):
            out = RelTensor.from_dense(
                torch.full(node.shape, node.value, dtype=torch.float32,
                           device=device))
        elif isinstance(node, E.MatMul):
            out = ev(node.x).matmul(ev(node.y))
        elif isinstance(node, E.Hadamard):
            out = ev(node.x).hadamard(ev(node.y))
        elif isinstance(node, E.Add):
            out = ev(node.x).add(ev(node.y))
        elif isinstance(node, E.Sub):
            out = ev(node.x).sub(ev(node.y))
        elif isinstance(node, E.Scale):
            out = ev(node.x).scale(node.c)
        elif isinstance(node, E.Transpose):
            out = ev(node.x).transpose()
        elif isinstance(node, MapDeriv):
            xv, fxv = ev(node.x), ev(node.fx)
            out = RelTensor(i=xv.i, j=xv.j, v=node.fn.df(xv.v, fxv.v),
                            shape=xv.shape)
        elif isinstance(node, E.Map):
            out = ev(node.x).map(node.fn.fn)
        else:  # zoo tier (and ReduceDeriv): shared dense semantics
            out = RelTensor.from_dense(
                dense.eval_node(node, lambda c: ev(c).to_dense(), device))
        cache[id(node)] = out
        return out

    try:
        return [ev(r) for r in roots]
    finally:
        # ``ev`` refers to itself through its closure: drop it, so that
        # the memo's intermediates are freed on return and not at
        # Python's next cyclic collection
        del ev
