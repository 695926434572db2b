"""Relational matrix representation and relational-algebra execution
(PyTorch port of ``repro.core.relational``).

The paper stores a matrix as the relation ``{[i, j, v]}`` (Fig. 1) and maps
matrix algebra onto relational algebra (Listing 4):

  matmul      γ_{m.i, n.j, sum(m.v·n.v)}(m ⋈_{m.j = n.i} n)
  hadamard    m ⋈_{m.i = n.i ∧ m.j = n.j} n,  select m.v·n.v
  transpose   select i as j, j as i, v
  f(X)        select i, j, f(v)

The matmul's join + group-by runs in ``kernels.ops.relational_matmul``: on
the card a sorted-segment reduction that never materialises the
``capacity × n`` join intermediate (Fig. 5's blow-up, which the plain CPU
version does build); the relation's canonical sort order is what makes the
segments contiguous.

Matrices are stored *densely* in the relation (no CSR — §6.2.2 of the paper),
in canonical row-major order. A ``RelTensor`` may also carry fewer valid
tuples than its capacity for genuinely sparse relations such as the one-hot
matrix; padding rows carry the out-of-range ``i == m`` so the group-by drops
them (scatter-drop semantics).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from ..obs import tracer as obs


@dataclasses.dataclass
class RelTensor:
    """The relation {[i, j, v]} with logical matrix shape ``shape``."""

    i: torch.Tensor       # int32[cap] row index; == shape[0] marks padding
    j: torch.Tensor       # int32[cap] col index
    v: torch.Tensor       # float[cap] value
    shape: tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_dense(x: torch.Tensor) -> "RelTensor":
        """Pivot a dense matrix into the canonical sorted relation."""
        m, n = x.shape
        with obs.span("rel.pivot", shape=(m, n)):
            i = torch.arange(m, dtype=torch.int32, device=x.device)
            j = torch.arange(n, dtype=torch.int32, device=x.device)
            return RelTensor(i=i.repeat_interleave(n), j=j.repeat(m),
                             v=x.reshape(-1), shape=(m, n))

    def to_dense(self) -> torch.Tensor:
        """Materialise the relation as a dense matrix (outer-join + coalesce:
        missing cells become 0, as in Listing 5's one-hot construction).
        Tuples outside the shape (the padding ``i == m``) land in a spare
        row that is cut off: they are dropped."""
        m, n = self.shape
        keep = (self.i >= 0) & (self.i < m) & (self.j >= 0) & (self.j < n)
        i = torch.where(keep, self.i, m).long()
        j = torch.where(keep, self.j, 0).long()
        out = torch.zeros((m + 1, n), dtype=self.v.dtype, device=self.v.device)
        out.index_put_((i, j), self.v, accumulate=True)
        return out[:m]

    def is_canonical(self) -> bool:
        m, n = self.shape
        return self.capacity == m * n

    # -- relational building blocks (Listing 4) ------------------------------
    def transpose(self) -> "RelTensor":
        """``select i as j, j as i, v`` + canonical re-sort.

        The index rename is free; re-establishing the canonical sort order
        (the clustered index) is a permutation known from the shape alone.
        """
        m, n = self.shape
        with obs.span("rel.transpose", shape=(m, n), tuples=self.capacity):
            key = self.j.long() * m + self.i
            order = torch.argsort(key, stable=True)
            return RelTensor(i=self.j[order], j=self.i[order],
                             v=self.v[order], shape=(n, m))

    def map(self, fn) -> "RelTensor":
        """``select i, j, f(v)`` — elementwise function application."""
        return RelTensor(i=self.i, j=self.j, v=fn(self.v), shape=self.shape)

    def _aligned(self, other: "RelTensor") -> None:
        if self.shape != other.shape or self.capacity != other.capacity:
            raise ValueError(
                f"elementwise join needs aligned relations: "
                f"{self.shape}/{self.capacity} vs {other.shape}/{other.capacity}")

    def hadamard(self, other: "RelTensor") -> "RelTensor":
        """Join on both indices; with both relations in canonical sorted
        order the equi-join is the identity alignment (sort-merge join)."""
        self._aligned(other)
        return RelTensor(i=self.i, j=self.j, v=self.v * other.v, shape=self.shape)

    def add(self, other: "RelTensor") -> "RelTensor":
        self._aligned(other)
        return RelTensor(i=self.i, j=self.j, v=self.v + other.v, shape=self.shape)

    def sub(self, other: "RelTensor") -> "RelTensor":
        self._aligned(other)
        return RelTensor(i=self.i, j=self.j, v=self.v - other.v, shape=self.shape)

    def scale(self, c: float) -> "RelTensor":
        return RelTensor(i=self.i, j=self.j, v=self.v * c, shape=self.shape)

    def matmul(self, other: "RelTensor") -> "RelTensor":
        """γ_{m.i, n.j, sum(m.v·n.v)}(m ⋈_{m.j = n.i} n).

        The rhs is canonical, so its tuples clustered by inner index are the
        rows of a (k, n) matrix; the join gathers the rhs row of each lhs
        tuple, the group-by sums them per outer row ``i``, and padding tuples
        (``i == m``) are dropped — all inside ``ops.relational_matmul``.
        """
        if self.shape[1] != other.shape[0]:
            raise ValueError(f"matmul: {self.shape} @ {other.shape}")
        if not other.is_canonical():
            raise ValueError("rhs of the join must be the canonical relation")
        m, k = self.shape
        n = other.shape[1]
        with obs.span("rel.matmul", shape=(m, k, n), tuples=self.capacity):
            out = ops.relational_matmul(self.i, self.j, self.v,
                                        other.v.reshape(k, n), m)
            return RelTensor.from_dense(out)

    def matmul_intermediate_tuples(self, other: "RelTensor") -> int:
        """Size (in tuples) of the join result before aggregation — the
        quantity Fig. 5 measures ("1000 tuples per entry")."""
        return self.capacity * other.shape[1]


# ---------------------------------------------------------------------------
# data transformation (paper §4.1)
# ---------------------------------------------------------------------------

def one_hot(labels: torch.Tensor, num_classes: int) -> RelTensor:
    """Listing 5: the sparse relation of ones. ``to_dense`` performs the
    outer join against the full index frame + coalesce(·, 0)."""
    rows = labels.shape[0]
    return RelTensor(
        i=torch.arange(rows, dtype=torch.int32, device=labels.device),
        j=labels.to(torch.int32),
        v=torch.ones((rows,), dtype=torch.float32, device=labels.device),
        shape=(rows, num_classes),
    )


def one_hot_dense(labels: torch.Tensor, num_classes: int) -> RelTensor:
    """The materialised (canonical) one-hot relation, as Listing 5 stores it."""
    return RelTensor.from_dense(one_hot(labels, num_classes).to_dense())


def features_to_relation(table: torch.Tensor) -> RelTensor:
    """Pivot an input table's attributes into the relation (Fig. 3):
    column index j = attribute position, row index i = row number."""
    return RelTensor.from_dense(table)


# ---------------------------------------------------------------------------
# memory model (paper §6.1 / Table 1)
# ---------------------------------------------------------------------------

BYTES_PER_INDEX = 8   # the paper assumes 8 B per index attribute
BYTES_PER_VALUE = 8   # double precision


def relation_bytes(shape: tuple[int, int]) -> int:
    """Storage of the canonical relation: 3 attributes × 8 B per tuple —
    the threefold overhead of §6.2.2."""
    return shape[0] * shape[1] * (2 * BYTES_PER_INDEX + BYTES_PER_VALUE)


def array_bytes(shape: tuple[int, int]) -> int:
    """Storage of the array data type: 8 B per entry."""
    return shape[0] * shape[1] * BYTES_PER_VALUE


def join_intermediate_bytes(m: int, k: int, n: int) -> int:
    """Join result of the matmul before aggregation: m·k tuples each joined
    with n partners, 3 attributes each (i, j, product)."""
    return m * k * n * (2 * BYTES_PER_INDEX + BYTES_PER_VALUE)
