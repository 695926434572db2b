"""Reverse-mode automatic differentiation over matrix expressions
(PyTorch port of ``repro.core.autodiff``: pure Python over the port's IR).

This is the paper's Algorithm 1 verbatim::

    function DERIVE(Z, seed)
      if   Z = X + Y  then DERIVE(X, seed); DERIVE(Y, seed)
      elif Z = X ∘ Y  then DERIVE(X, seed ∘ y); DERIVE(Y, seed ∘ x)
      elif Z = X · Y  then DERIVE(X, seed · yᵀ); DERIVE(Y, xᵀ · seed)
      elif Z = f(X)   then DERIVE(X, seed ∘ f'(x))
      else  ∂/∂Z ← ∂/∂Z + seed

Lower-case letters (``x``, ``y``) are the *cached forward values*: in the
output gradient graph they appear as references to forward-pass nodes, which
the engines evaluate once and memoise — each shared node is one CTE, and the
derivative CTEs reuse it, exactly as Listing 7 reuses ``a_xh``/``a_ho``.

``f'(x)`` needs access to both the input value and the cached output value
(sigmoid: ``out ∘ (1-out)``); we introduce a ``MapDeriv`` marker node that the
engines evaluate from the memoised forward values.
"""
from __future__ import annotations

import dataclasses

from . import expr as E


@dataclasses.dataclass(frozen=True, eq=False)
class MapDeriv(E.Expr):
    """f'(x) evaluated from the cached forward values of ``x`` (and ``f(x)``)."""

    fn: E.MapFn = None
    x: E.Expr = None          # the input of the Map node
    fx: E.Expr = None         # the Map node itself (cached output)

    def children(self):
        # Both are forward nodes; listing them keeps topo_order correct.
        return (self.x, self.fx)


@dataclasses.dataclass(frozen=True, eq=False)
class ReduceDeriv(E.Expr):
    """The argmax indicator of a cached max-RowReduce: 1 where ``x`` equals
    its row's (axis=1) / column's (axis=0) cached maximum, else 0.  Ties
    all receive 1 (the subgradient convention every engine and the SQL
    lowering share — what matters for the differential tests is that the
    three backends agree)."""

    x: E.Expr = None          # the input of the RowReduce node
    red: E.Expr = None        # the RowReduce node itself (cached max)
    axis: int = 1

    def children(self):
        return (self.x, self.red)


def _expand(reduced: E.Expr, axis: int, shape: tuple[int, int]) -> E.Expr:
    """Broadcast a keepdims reduce back to ``shape`` with a ones matmul:
    (r, 1) · 1_{1×c} for axis=1, 1_{r×1} · (1, c) for axis=0 — no new node
    type needed, the constant ones matrix is Listing 5's series cross
    join."""
    if axis == 1:
        return E.matmul(reduced, E.const(1.0, (1, shape[1])))
    return E.matmul(E.const(1.0, (shape[0], 1)), reduced)


def derive(z: E.Expr, seed: E.Expr, grads: dict[E.Var, E.Expr] | None = None
           ) -> dict[E.Var, E.Expr]:
    """Algorithm 1. Returns {leaf Var: gradient expression}."""
    if grads is None:
        grads = {}

    if isinstance(z, E.Add):
        derive(z.x, seed, grads)
        derive(z.y, seed, grads)
    elif isinstance(z, E.Sub):
        derive(z.x, seed, grads)
        derive(z.y, E.scale(-1.0, seed), grads)
    elif isinstance(z, E.Hadamard):
        derive(z.x, E.hadamard(seed, z.y), grads)
        derive(z.y, E.hadamard(seed, z.x), grads)
    elif isinstance(z, E.MatMul):
        derive(z.x, E.matmul(seed, E.transpose(z.y)), grads)
        derive(z.y, E.matmul(E.transpose(z.x), seed), grads)
    elif isinstance(z, E.Map):
        fprime = MapDeriv(name=f"d{z.fn.name}_{z.name}", shape=z.shape,
                          fn=z.fn, x=z.x, fx=z)
        if E.is_auto_named(z):  # name embeds z's counter suffix
            E.mark_auto_named(fprime)
        derive(z.x, E.hadamard(seed, fprime), grads)
    elif isinstance(z, E.Scale):
        derive(z.x, E.scale(z.c, seed), grads)
    elif isinstance(z, E.Transpose):
        derive(z.x, E.transpose(seed), grads)
    elif isinstance(z, E.RowReduce):
        bseed = _expand(seed, z.axis, z.x.shape)      # broadcast back
        if z.kind == "sum":
            derive(z.x, bseed, grads)
        else:                                          # max: argmax indicator
            ind = ReduceDeriv(name=f"dmax_{z.name}", shape=z.x.shape,
                              x=z.x, red=z, axis=z.axis)
            if E.is_auto_named(z):  # name embeds z's counter suffix
                E.mark_auto_named(ind)
            derive(z.x, E.hadamard(bseed, ind), grads)
    elif isinstance(z, E.Softmax):
        # d/dx softmax(x) @ g = s ∘ (g − rowsum(g ∘ s)·1ᵀ), s cached
        gs = E.hadamard(seed, z)
        rowsum = E.row_reduce(gs, "sum", axis=1)
        derive(z.x, E.hadamard(z, E.sub(seed, _expand(rowsum, 1, z.shape))),
               grads)
    elif isinstance(z, E.ArgTopK):
        pass  # selection mask: zero gradient everywhere (like Const)
    elif isinstance(z, E.Gather):
        derive(z.x, E.scatter(seed, z.idx, z.x.shape[0]), grads)
    elif isinstance(z, E.Scatter):
        derive(z.x, E.gather(seed, z.idx), grads)
    elif isinstance(z, E.RowShift):
        derive(z.x, E.row_shift(seed, -z.offset), grads)
    elif isinstance(z, E.Recurrence):
        # The adjoint of an affine scan is the same scan run the other way:
        #   λ_t = g_t + a_{t+1} ∘ λ_{t+1}  (forward z; mirrored if reverse)
        # then ∂b = λ and ∂a_t = λ_t ∘ s_{t∓1} with s the cached output.
        step = -1 if not z.reverse else 1
        a_next = E.row_shift(z.a, step)       # a_next[t] = a[t+1] (fwd case)
        lam = E.recurrence(a_next, seed, reverse=not z.reverse)
        s_prev = E.row_shift(z, -step)        # s_prev[t] = s[t-1] (fwd case)
        derive(z.b, lam, grads)
        derive(z.a, E.hadamard(lam, s_prev), grads)
    elif isinstance(z, E.MatRecurrence):
        # Matrix-valued scan adjoint: the same scan the other way with
        # TRANSPOSED coefficients (forward z, row-vector state s):
        #   λ_t = g_t + λ_{t+1} · A_{t+1}ᵀ
        # then ∂b = λ and ∂A_t = s_{t-1}ᵀ λ_t — one outer product per
        # step, stacked like the A relation (StepOuter).  The block shift
        # A_{t+1} is a RowShift of the stack by a whole block (±D rows,
        # zero-filled — exactly the λ boundary condition); transposition
        # is the scan's own `transposed` flag, flipped.
        d = z.b.shape[1]
        step = -1 if not z.reverse else 1
        a_next = E.row_shift(z.a, step * d)   # block t ↦ block t+1 (fwd)
        lam = E.mat_recurrence(a_next, seed, reverse=not z.reverse,
                               transposed=not z.transposed)
        s_prev = E.row_shift(z, -step)        # s_prev[t] = s[t-1] (fwd)
        derive(z.b, lam, grads)
        if z.transposed:                      # s_t = s_{t-1}·A_tᵀ + b_t
            derive(z.a, E.step_outer(lam, s_prev), grads)
        else:
            derive(z.a, E.step_outer(s_prev, lam), grads)
    elif isinstance(z, E.Const):
        pass  # constants carry no gradient
    elif isinstance(z, E.Var):
        if z in grads:
            grads[z] = E.add(grads[z], seed)
        else:
            grads[z] = seed
    else:  # pragma: no cover
        raise TypeError(f"unknown node {type(z)}")
    return grads


def gradients(loss: E.Expr, wrt: list[E.Var]) -> dict[E.Var, E.Expr]:
    """Gradient graphs of a scalar-per-entry loss w.r.t. ``wrt``.

    The paper seeds with the derivative of the mean-squared-error
    (Equation 6, ``l_ho = 2(a_ho - y)``); calling ``derive`` on the full loss
    expression ``(m(x)-y)^∘2`` with an all-ones seed produces the identical
    graph via the f(X) rule on ``sqr``.
    """
    ones = E.const(1.0, loss.shape)
    grads = derive(loss, ones)
    missing = [v for v in wrt if v not in grads]
    if missing:
        raise ValueError(f"no gradient flows to {[v.name for v in missing]}")
    return {v: grads[v] for v in wrt}
