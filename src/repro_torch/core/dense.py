"""The "array data type" engine (paper Section 5), PyTorch port of
``repro.core.dense``.

The paper's second backend extends SQL arrays (``float[][]``) with matrix
algebra: ``**`` (matmul), ``*`` (Hadamard), ``-``, ``transpose``, ``sig`` and
elementwise aggregation. Here the array data type is a dense
``torch.Tensor``.  The "condensing of subsequent calls" that §6.3.2 plans
for the database's optimiser is done for the model's layers: a
``Map(SIGMOID, MatMul(x, w))`` node runs as one fused kernel
(``ops.fused_sigmoid_matmul``), and the sigmoid's derivative reads only
the cached output, so the pre-activation is never materialised.  A
``Gather`` runs as the one-hot row-gather kernel (``ops.onehot_embed``).
The backward products stay ``torch.matmul``.

``eval_node`` is the single-node semantics shared with the relational
engine's fallback path (``core.rel_engine`` densifies, applies the same
rule, re-pivots) — one place defines what every zoo primitive means.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import expr as E
from .autodiff import MapDeriv, ReduceDeriv


def topk_mask(v: torch.Tensor, k: int) -> torch.Tensor:
    """The 0/1 indicator of each row's k largest entries, ties broken
    toward the smaller column index — byte-for-byte the ordering of the SQL
    lowering (``order by v desc, j asc``): rank(i, j) = #{m: v[i,m] >
    v[i,j]} + #{m < j: v[i,m] = v[i,j]}."""
    c = v.shape[1]
    gt = (v[:, None, :] > v[:, :, None]).sum(-1)              # (r, j) strict
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=v.device),
                     -1)                                      # m < j
    eq = ((v[:, None, :] == v[:, :, None]) & tri[None]).sum(-1)
    return ((gt + eq) < k).to(v.dtype)


def row_shift(xv: torch.Tensor, offset: int) -> torch.Tensor:
    """out[t] = x[t - offset], zero fill (positive offset shifts down)."""
    t = xv.shape[0]
    if offset == 0:
        return xv
    out = torch.zeros_like(xv)
    if abs(offset) >= t:
        return out
    if offset > 0:
        out[offset:] = xv[:-offset]
    else:
        out[:offset] = xv[-offset:]
    return out


def affine_scan(av: torch.Tensor, bv: torch.Tensor,
                reverse: bool) -> torch.Tensor:
    """s_t = a_t ∘ s_{t∓1} + b_t down (or up) the rows, s outside = 0."""
    steps = range(av.shape[0] - 1, -1, -1) if reverse else range(av.shape[0])
    s = torch.zeros_like(av[0])
    outs = [None] * av.shape[0]
    for t in steps:
        s = av[t] * s + bv[t]
        outs[t] = s
    return torch.stack(outs)


def mat_affine_scan(av: torch.Tensor, bv: torch.Tensor, reverse: bool,
                    transposed: bool) -> torch.Tensor:
    """s_t = s_{t∓1} · A_t + b_t with row-vector state; ``av`` is the
    (T·D, D) block stack, A_t = av[(t-1)D:tD] (transposed: A_tᵀ)."""
    t_rows, d = bv.shape
    blocks = av.reshape(t_rows, d, d)
    if transposed:
        blocks = blocks.transpose(1, 2)
    steps = range(t_rows - 1, -1, -1) if reverse else range(t_rows)
    s = torch.zeros_like(bv[0])
    outs = [None] * t_rows
    for t in steps:
        s = s @ blocks[t] + bv[t]
        outs[t] = s
    return torch.stack(outs)


def _index_column(node: E.Expr, ev, n_rows: int) -> torch.Tensor:
    """The (S,) int32 index column of a Gather/Scatter, bounds-checked on
    every evaluation.  Out-of-range indices are a contract violation the
    backends resolve differently in silence (a gather clamps, the SQL join
    drops the tuple and the pivot zero-fills), so raise eagerly."""
    idx = ev(node.idx)[:, 0]
    if idx.shape[0]:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n_rows:
            raise ValueError(
                f"{type(node).__name__} index relation out of range: "
                f"values span [{lo}, {hi}], valid rows 0..{n_rows - 1}")
    return idx.to(torch.int32)


def eval_node(node: E.Expr, ev, device: torch.device) -> torch.Tensor:
    """One node's dense value; ``ev(child)`` supplies child values and
    ``device`` places the constants."""
    if isinstance(node, E.Const):
        return torch.full(node.shape, node.value, dtype=torch.float32,
                          device=device)
    if isinstance(node, E.MatMul):
        return ev(node.x) @ ev(node.y)
    if isinstance(node, E.Hadamard):
        return ev(node.x) * ev(node.y)
    if isinstance(node, E.Add):
        return ev(node.x) + ev(node.y)
    if isinstance(node, E.Sub):
        return ev(node.x) - ev(node.y)
    if isinstance(node, E.Scale):
        return node.c * ev(node.x)
    if isinstance(node, E.Transpose):
        return ev(node.x).T
    if isinstance(node, MapDeriv):
        xv = None if node.fn in E.DF_FROM_OUTPUT else ev(node.x)
        return node.fn.df(xv, ev(node.fx))
    if isinstance(node, ReduceDeriv):
        return (ev(node.x) == ev(node.red)).to(torch.float32)
    if isinstance(node, E.Map):
        if node.fn is E.SIGMOID and isinstance(node.x, E.MatMul):
            return ops.fused_sigmoid_matmul(ev(node.x.x), ev(node.x.y))
        return node.fn.fn(ev(node.x))
    if isinstance(node, E.RowReduce):
        xv = ev(node.x)
        if node.kind == "sum":
            return xv.sum(dim=node.axis, keepdim=True)
        return xv.amax(dim=node.axis, keepdim=True)
    if isinstance(node, E.Softmax):
        return torch.softmax(ev(node.x), dim=1)
    if isinstance(node, E.ArgTopK):
        return topk_mask(ev(node.x), node.k)
    if isinstance(node, E.Gather):
        return ops.onehot_embed(_index_column(node, ev, node.x.shape[0]),
                                ev(node.x))
    if isinstance(node, E.Scatter):
        xv = ev(node.x)
        idx = _index_column(node, ev, node.shape[0])
        out = torch.zeros((node.shape[0], xv.shape[1]), dtype=xv.dtype,
                          device=xv.device)
        return out.index_add_(0, idx.long(), xv)
    if isinstance(node, E.RowShift):
        return row_shift(ev(node.x), node.offset)
    if isinstance(node, E.Recurrence):
        return affine_scan(ev(node.a), ev(node.b), node.reverse)
    if isinstance(node, E.MatRecurrence):
        return mat_affine_scan(ev(node.a), ev(node.b), node.reverse,
                               node.transposed)
    if isinstance(node, E.StepOuter):
        xv, yv = ev(node.x), ev(node.y)
        return (xv[:, :, None] * yv[:, None, :]).reshape(node.shape)
    raise TypeError(f"unknown node {type(node)}")


def evaluate(roots: list[E.Expr], env: dict[str, torch.Tensor],
             device="cuda") -> list[torch.Tensor]:
    """Evaluate expression DAG(s) with per-node memoisation (CTE caching).
    ``env`` holds the leaves, on ``device``."""
    device = torch.device(device)
    cache: dict[int, torch.Tensor] = {}

    def ev(node: E.Expr) -> torch.Tensor:
        if id(node) in cache:
            return cache[id(node)]
        out = env[node.name] if isinstance(node, E.Var) else eval_node(
            node, ev, device)
        cache[id(node)] = out
        return out

    try:
        return [ev(r) for r in roots]
    finally:
        # ``ev`` refers to itself through its closure: drop it, so that
        # the memo's intermediates are freed on return and not at
        # Python's next cyclic collection
        del ev
