"""Matrix-expression IR — the paper's CTE graph (PyTorch port of
``repro.core.expr``: the same node set, names and SQL renderings; the
``MapFn`` value functions act on torch tensors).

Every node corresponds to one CTE in the paper's SQL formulation
(Listing 7: ``a_xh``, ``a_ho``, ``l_ho``, ``d_ho``, ``l_xh``, ``d_xh``, ``d_w``):
a named, cached matrix expression. The engines (``core.dense``,
``core.relational``) evaluate the DAG with per-node memoisation — exactly the
"cached expression computed in the forward pass" of the paper's Section 2 —
and ``core.autodiff`` implements Algorithm 1 over these node types.

Node types mirror the paper's building blocks (Listing 4):

  MatMul     X · Y        join on inner index + group-by sum
  Hadamard   X ∘ Y        join on both indices
  Add / Sub  X ± Y        join on both indices
  Scale      c · X        map in the select-clause
  Map        f(X)         map in the select-clause (sigmoid, 1-x, x², …)
  Transpose  Xᵀ           index rename
  Var        leaf         a stored table (weights / data)
  Const      literal      generate_series-style constant matrix

The **DAG-zoo tier** (paper §8 outlook: "the relational building blocks
generalize beyond MLPs") extends the IR beyond dense 2-D algebra — each
node still denotes a dense matrix relation, so the inner-join/dense-cell
invariants of the base tier carry over:

  RowReduce  Σ/max over one axis     GROUP BY with sum()/max(), keepdims
  Softmax    row-wise softmax        exp/max/sum joins (numerically stable)
  ArgTopK    top-k indicator mask    window rank (or correlated count)
  Gather     row-index select        self-join on an index relation
  Scatter    row-index accumulate    join + GROUP BY, zero-filled frame
  RowShift   shift rows, zero fill   index arithmetic + frame left join
  Recurrence s_t = a_t∘s_{t-1}+b_t   recursive CTE (the Listing-7 machinery)

The **matrix-valued recurrence tier** (LRU/S5/Mamba-2 block scans)
generalises the elementwise scan to per-step *matrix* coefficients:

  MatRecurrence s_t = s_{t-1}·A_t + b_t   per-step (D, D) blocks stacked
                                          into one (T·D, D) relation; a
                                          recursive CTE whose tuple holds
                                          the state row (D columns, or
                                          one array-typed value)
  StepOuter     out[tD+k, j] = x[t,k]·y[t,j]   the stacked per-step outer
                                          product — Algorithm 1's ∂A_t

Index relations (the ``idx`` child of Gather/Scatter) are ordinary
``{[i, j, v]}`` matrices of shape (S, 1) whose *values* are 0-based row
numbers — at the SQL boundary the lowering adds the +1 of the 1-based
storage convention.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Callable, Optional

import torch

_counter = itertools.count()

#: nodes whose name came from ``_fresh`` rather than the caller.  SQL
#: rendering (``core.sqlgen``) re-names these deterministically by topo
#: position, so two structurally identical DAGs built at different counter
#: states (different sessions, different test orderings) render to the
#: *same* SQL text — the property the persistent plan cache relies on.
_AUTO_NAMED: "weakref.WeakSet[Expr]" = weakref.WeakSet()


def _fresh(prefix: str) -> str:
    return f"{prefix}_{next(_counter)}"


def mark_auto_named(node: "Expr") -> "Expr":
    """Record that ``node.name`` is generated, not semantic."""
    _AUTO_NAMED.add(node)
    return node


def is_auto_named(node: "Expr") -> bool:
    return node in _AUTO_NAMED


@dataclasses.dataclass(frozen=True, eq=False)
class Expr:
    """Base class. ``shape`` is the logical matrix shape (rows, cols)."""

    name: str
    shape: tuple[int, int]

    # -- operator sugar ----------------------------------------------------
    def __matmul__(self, other: "Expr") -> "Expr":
        return matmul(self, other)

    def __mul__(self, other) -> "Expr":
        if isinstance(other, Expr):
            return hadamard(self, other)
        return scale(float(other), self)

    __rmul__ = __mul__

    def __add__(self, other: "Expr") -> "Expr":
        return add(self, other)

    def __sub__(self, other: "Expr") -> "Expr":
        return sub(self, other)

    @property
    def T(self) -> "Expr":
        return transpose(self)

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class Var(Expr):
    """Leaf: a stored table (weight matrix or input relation)."""


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    """A constant matrix (broadcast scalar), e.g. the ``1`` in ``1 - a``."""

    value: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class MatMul(Expr):
    x: Expr = None
    y: Expr = None

    def children(self):
        return (self.x, self.y)


@dataclasses.dataclass(frozen=True, eq=False)
class Hadamard(Expr):
    x: Expr = None
    y: Expr = None

    def children(self):
        return (self.x, self.y)


@dataclasses.dataclass(frozen=True, eq=False)
class Add(Expr):
    x: Expr = None
    y: Expr = None

    def children(self):
        return (self.x, self.y)


@dataclasses.dataclass(frozen=True, eq=False)
class Sub(Expr):
    x: Expr = None
    y: Expr = None

    def children(self):
        return (self.x, self.y)


@dataclasses.dataclass(frozen=True, eq=False)
class Scale(Expr):
    c: float = 1.0
    x: Expr = None

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class Transpose(Expr):
    x: Expr = None

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class MapFn:
    """An elementwise function with its derivative.

    ``df(x_val, out_val)`` returns f'(x) given the input value and the cached
    output value — e.g. sigmoid's derivative is expressed from the *output*
    (``out∘(1-out)``), matching the paper's Equations 7/9 which reuse the
    cached CTE ``a_ho``/``a_xh`` rather than re-evaluating sig'.
    ``sql(v)`` renders the select-clause expression for sqlgen.
    For the functions in ``DF_FROM_OUTPUT`` ``df`` reads only ``out``, and
    the dense engine passes ``None`` for ``x``.
    """

    name: str
    fn: Callable
    df: Callable
    sql: Callable[[str], str]

    @property
    def udf(self) -> str:
        """Name of the function in the UDF array extension
        (``db.dialect.ARRAY_UDFS``) — the array-dialect and
        Listing-10 call renderings both spell ``f(X)`` as ``m<name>(x)``."""
        return f"m{self.name}"


RECIP = MapFn(
    name="recip",
    fn=lambda x: 1.0 / x,
    df=lambda x, out: -out * out,
    sql=lambda v: f"1.0/({v})",
)
SIGMOID = MapFn(
    name="sig",
    fn=lambda x: 1.0 / (1.0 + torch.exp(-x)),
    df=lambda x, out: out * (1.0 - out),
    sql=lambda v: f"1/(1+exp(-{v}))",
)
SQUARE = MapFn(
    name="sqr",
    fn=lambda x: x * x,
    df=lambda x, out: 2.0 * x,
    sql=lambda v: f"{v}*{v}",
)
RELU = MapFn(
    name="relu",
    fn=lambda x: torch.clamp(x, min=0.0),
    df=lambda x, out: (x > 0).to(x.dtype),
    sql=lambda v: f"greatest({v},0)",
)
ONE_MINUS = MapFn(
    name="one_minus",
    fn=lambda x: 1.0 - x,
    df=lambda x, out: torch.full_like(x, -1.0),
    sql=lambda v: f"1-{v}",
)

MAP_FNS = {f.name: f for f in (SIGMOID, SQUARE, RELU, ONE_MINUS, RECIP)}

#: MapFns whose derivative is a function of the cached output alone, so
#: differentiating them never needs the Map's input: on the MLP path the
#: pre-activations ``z_xh``/``z_ho`` are then never materialised.
DF_FROM_OUTPUT = (SIGMOID, RECIP)


@dataclasses.dataclass(frozen=True, eq=False)
class Map(Expr):
    fn: MapFn = None
    x: Expr = None

    def children(self):
        return (self.x,)


# ---------------------------------------------------------------------------
# DAG-zoo tier (reductions, gather/scatter, shift, scan)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RowReduce(Expr):
    """Reduce one axis with ``sum`` or ``max``, keepdims: axis=1 collapses
    columns (shape (r, 1)), axis=0 collapses rows (shape (1, c)).  Lowers to
    GROUP BY over the kept index."""

    x: Expr = None
    kind: str = "sum"        # "sum" | "max"
    axis: int = 1

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class Softmax(Expr):
    """Row-wise (axis=1) numerically stable softmax.  Lowers to a join
    against the per-row max/denominator aggregate."""

    x: Expr = None

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class ArgTopK(Expr):
    """The 0/1 indicator of each row's ``k`` largest entries (ties broken
    toward the smaller column index).  This is the relational rendering of
    an arg-result: a set of (i, j) pairs IS a sparse relation of ones —
    Listing 5's one-hot construction — kept dense here so downstream
    inner joins stay aligned.  Non-differentiable (selection): gradients
    flow through the values the mask is *applied to*, never the mask."""

    x: Expr = None
    k: int = 1

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class Gather(Expr):
    """Row-index select: ``out[s, :] = x[idx[s], :]``.  ``idx`` is an index
    relation — an (S, 1) matrix whose values are 0-based row numbers of
    ``x``.  Lowers to a self-join of ``x`` against the index relation.
    Index values MUST lie in 0..rows(x)-1: eager dense/relational
    evaluation raises on violations, jit/SQL behaviour is
    backend-defined (clamp vs. zero-fill)."""

    x: Expr = None
    idx: Expr = None

    def children(self):
        return (self.x, self.idx)


@dataclasses.dataclass(frozen=True, eq=False)
class Scatter(Expr):
    """Row-index accumulate (Gather's adjoint): ``out[r, :] = Σ_{s:
    idx[s]=r} x[s, :]`` with ``shape[0]`` output rows.  Lowers to the join
    + GROUP BY sum, left-joined onto a zero frame so rows that receive no
    tuples stay present (dense-relation invariant)."""

    x: Expr = None
    idx: Expr = None

    def children(self):
        return (self.x, self.idx)


@dataclasses.dataclass(frozen=True, eq=False)
class RowShift(Expr):
    """Shift rows by ``offset`` (positive = down / toward larger i), zero
    fill: ``out[t, :] = x[t - offset, :]`` where defined, else 0.  The
    token-shift of RWKV and the boundary operator of Recurrence's autodiff
    rule."""

    x: Expr = None
    offset: int = 1

    def children(self):
        return (self.x,)


@dataclasses.dataclass(frozen=True, eq=False)
class Recurrence(Expr):
    """Elementwise affine scan down the rows (each column independent):

        forward:  s_t = a_t ∘ s_{t-1} + b_t,   s_0 = 0,   t = 1..T
        reverse:  s_t = a_t ∘ s_{t+1} + b_t,   s_{T+1} = 0,   t = T..1

    A non-zero initial state folds into ``b``: b₁' = a₁ ∘ s₀ + b₁.  Lowers
    to a recursive CTE — the Listing-7 recursion machinery, one tuple per
    (t, j) walking its own column chain (queue semantics compatible)."""

    a: Expr = None
    b: Expr = None
    reverse: bool = False

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True, eq=False)
class MatRecurrence(Expr):
    """Matrix-valued affine scan down the rows (LRU/S5/Mamba-2 blocks):

        forward:  s_t = s_{t-1} · A_t + b_t,   s_0 = 0,   t = 1..T
        reverse:  s_t = s_{t+1} · A_t + b_t,   s_{T+1} = 0,   t = T..1

    with the state a ROW vector s_t ∈ R^{1×D} and ``a`` the (T·D, D)
    stack of per-step square blocks: A_t = a[(t-1)·D : t·D, :].
    ``transposed`` uses A_tᵀ in the step — the Algorithm-1 adjoint scan
    runs with transposed coefficients, no block-transpose node needed.
    A non-zero initial state folds into ``b``: b₁' = s₀·A₁ + b₁.

    Diagonal blocks (the LRU/S5 fast path) ARE the elementwise
    :class:`Recurrence`; this node carries the dense-block case.  Both
    representations lower to ONE genuine recursive CTE whose tuple
    carries the whole state row: D columns with a scalar-subquery matvec
    (relational — cell-granularity recursion cannot mix the D previous
    cells under the single-reference/no-aggregate recursion rules), or
    one array-typed value stepped by the ``mrecurstep`` UDF (array)."""

    a: Expr = None           # (T·D, D) stacked blocks
    b: Expr = None           # (T, D)
    reverse: bool = False
    transposed: bool = False

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True, eq=False)
class StepOuter(Expr):
    """The stacked per-step outer product: ``out[(t-1)·K + k, j] =
    x[t, k] · y[t, j]`` for x (T, K), y (T, J) — shape (T·K, J).  This is
    the shape of ∂loss/∂A for :class:`MatRecurrence` (one outer product
    of cached state and adjoint per step, stacked like the A relation).
    Lowers to a single equi-join on t with index arithmetic on i."""

    x: Expr = None
    y: Expr = None

    def children(self):
        return (self.x, self.y)


# ---------------------------------------------------------------------------
# constructors with shape checking
# ---------------------------------------------------------------------------

def var(name: str, shape: tuple[int, int]) -> Var:
    return Var(name=name, shape=tuple(shape))


def _named(node: Expr, name: Optional[str]) -> Expr:
    """Register ``node`` as auto-named when the caller gave no name."""
    return node if name else mark_auto_named(node)


def const(value: float, shape: tuple[int, int]) -> Const:
    return mark_auto_named(
        Const(name=_fresh("const"), shape=tuple(shape), value=float(value)))


def matmul(x: Expr, y: Expr, name: Optional[str] = None) -> MatMul:
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul inner dims: {x.shape} @ {y.shape}")
    return _named(MatMul(name=name or _fresh("mm"),
                         shape=(x.shape[0], y.shape[1]), x=x, y=y), name)


def _elementwise(cls, x: Expr, y: Expr, prefix: str, name=None):
    if x.shape != y.shape:
        raise ValueError(f"{prefix} shapes: {x.shape} vs {y.shape}")
    return _named(cls(name=name or _fresh(prefix), shape=x.shape, x=x, y=y),
                  name)


def hadamard(x: Expr, y: Expr, name=None) -> Hadamard:
    return _elementwise(Hadamard, x, y, "had", name)


def add(x: Expr, y: Expr, name=None) -> Add:
    return _elementwise(Add, x, y, "add", name)


def sub(x: Expr, y: Expr, name=None) -> Sub:
    return _elementwise(Sub, x, y, "sub", name)


def scale(c: float, x: Expr, name=None) -> Scale:
    return _named(Scale(name=name or _fresh("scale"), shape=x.shape,
                        c=float(c), x=x), name)


def transpose(x: Expr, name=None) -> Transpose:
    return _named(Transpose(name=name or _fresh("t"),
                            shape=(x.shape[1], x.shape[0]), x=x), name)


def mapfn(fn: MapFn, x: Expr, name=None) -> Map:
    return _named(Map(name=name or _fresh(fn.name), shape=x.shape,
                      fn=fn, x=x), name)


def sigmoid(x: Expr, name=None) -> Map:
    return mapfn(SIGMOID, x, name)


def square(x: Expr, name=None) -> Map:
    return mapfn(SQUARE, x, name)


def relu(x: Expr, name=None) -> Map:
    return mapfn(RELU, x, name)


def recip(x: Expr, name=None) -> Map:
    return mapfn(RECIP, x, name)


def row_reduce(x: Expr, kind: str = "sum", axis: int = 1, name=None
               ) -> RowReduce:
    if kind not in ("sum", "max"):
        raise ValueError(f"row_reduce kind {kind!r}; have 'sum'/'max'")
    if axis not in (0, 1):
        raise ValueError(f"row_reduce axis {axis!r}; have 0/1")
    shape = (x.shape[0], 1) if axis == 1 else (1, x.shape[1])
    return _named(RowReduce(name=name or _fresh(f"r{kind}"), shape=shape,
                            x=x, kind=kind, axis=axis), name)


def softmax(x: Expr, name=None) -> Softmax:
    return _named(Softmax(name=name or _fresh("smax"), shape=x.shape, x=x),
                  name)


def argtopk(x: Expr, k: int, name=None) -> ArgTopK:
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"argtopk k={k} outside 1..{x.shape[1]}")
    return _named(ArgTopK(name=name or _fresh("topk"), shape=x.shape,
                          x=x, k=int(k)), name)


def gather(x: Expr, idx: Expr, name=None) -> Gather:
    if idx.shape[1] != 1:
        raise ValueError(f"gather index relation must be (S, 1), "
                         f"got {idx.shape}")
    return _named(Gather(name=name or _fresh("gath"),
                         shape=(idx.shape[0], x.shape[1]), x=x, idx=idx),
                  name)


def scatter(x: Expr, idx: Expr, n_rows: int, name=None) -> Scatter:
    if idx.shape != (x.shape[0], 1):
        raise ValueError(f"scatter index relation must be ({x.shape[0]}, 1),"
                         f" got {idx.shape}")
    return _named(Scatter(name=name or _fresh("scat"),
                          shape=(int(n_rows), x.shape[1]), x=x, idx=idx),
                  name)


def row_shift(x: Expr, offset: int = 1, name=None) -> RowShift:
    return _named(RowShift(name=name or _fresh("shift"), shape=x.shape,
                           x=x, offset=int(offset)), name)


def recurrence(a: Expr, b: Expr, reverse: bool = False, name=None
               ) -> Recurrence:
    if a.shape != b.shape:
        raise ValueError(f"recurrence shapes: {a.shape} vs {b.shape}")
    return _named(Recurrence(name=name or _fresh("rec"), shape=a.shape,
                             a=a, b=b, reverse=bool(reverse)), name)


def mat_recurrence(a: Expr, b: Expr, reverse: bool = False,
                   transposed: bool = False, name=None) -> MatRecurrence:
    t, d = b.shape
    if a.shape != (t * d, d):
        raise ValueError(
            f"mat_recurrence coefficient stack must be (T·D, D) = "
            f"({t * d}, {d}) for b {b.shape}, got {a.shape}")
    return _named(MatRecurrence(name=name or _fresh("mrec"), shape=b.shape,
                                a=a, b=b, reverse=bool(reverse),
                                transposed=bool(transposed)), name)


def step_outer(x: Expr, y: Expr, name=None) -> StepOuter:
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"step_outer step counts: {x.shape} vs {y.shape}")
    return _named(StepOuter(name=name or _fresh("souter"),
                            shape=(x.shape[0] * x.shape[1], y.shape[1]),
                            x=x, y=y), name)


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------

def topo_order(*roots: Expr) -> list[Expr]:
    """Deterministic post-order (children before parents), deduplicated."""
    seen: dict[int, Expr] = {}
    order: list[Expr] = []

    def visit(node: Expr):
        if id(node) in seen:
            return
        seen[id(node)] = node
        for c in node.children():
            visit(c)
        order.append(node)

    for r in roots:
        visit(r)
    return order


def free_vars(*roots: Expr) -> list[Var]:
    return [n for n in topo_order(*roots) if isinstance(n, Var)]
