"""Pivoting between dense arrays and the relational representation.

The paper stores a matrix as the relation ``{[i, j, v]}`` (Fig. 1) with
**1-based** indices (``generate_series(1, n)`` in Listing 5); the tensor side
(:class:`repro_torch.core.relational.RelTensor`) is 0-based.  This module is
the boundary: every matrix entering the database is pivoted to 1-based
tuples, everything read back is pivoted to a dense 0-based array.  A tensor
crosses to the host through :func:`repro_torch.device.to_host`; relations
read back become tensors on the device the caller names.

All pivots are vectorized (``np.repeat``/``tile``/``ravel`` plus fancy
indexing) — at MNIST scale (784×256 ≈ 200k cells) the per-cell Python loop
of the original implementation dominates ingestion by >10×.  That loop is
kept as :func:`matrix_to_rows_percell`, the measured baseline of
``benchmarks/bench_mnist_db.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.relational import RelTensor
from ..device import resolve, to_host
from ..obs import tracer_of
from .adapter import Adapter, _check_ident
from .dialect import json_to_matrix, matrix_to_json


def _count_ingest(adapter: Adapter, a: np.ndarray) -> None:
    """Ingestion volume counters (``SQLEngine.stats`` → ``adapter``)."""
    adapter.add_counters(ingest_bytes=int(a.nbytes),
                        ingest_cells=int(a.size))


#: largest leaf (in cells) whose client-side copy is retained as the diff
#: base of the bound-parameter delta path — optimizer state and per-step
#: inputs qualify; MNIST-scale weight relations stay resident but refresh
#: via DELETE + re-insert (no DDL churn) instead of cell updates
DELTA_MAX_CELLS = 65536


def _register_matrix(adapter: Adapter, name: str, a: np.ndarray,
                     representation: str, cache: bool = True) -> None:
    """Record what the table now holds, enabling the delta path for the
    next refresh of the same leaf (small relational matrices additionally
    keep a client copy to diff against)."""
    adapter.matrix_meta[name] = (representation, a.shape)
    if (cache and representation == "relational"
            and 0 < a.size <= DELTA_MAX_CELLS):
        adapter.matrix_cache[name] = a.copy()
    else:
        adapter.matrix_cache.pop(name, None)
    # pin the caches to the table's current generation: a sibling pooled
    # connection's write bumps it, flipping adapter.cache_fresh(name) off
    adapter.matrix_gen[name] = adapter.table_gen(name)


#: column layout of every matrix table, matching the paper's Fig. 1
MATRIX_COLUMNS = (("i", "integer"), ("j", "integer"), ("v", "double precision"))

#: column layout of an array-representation matrix table: the whole matrix
#: is ONE row, column ``m`` holding the JSON array codec (paper §5)
ARRAY_COLUMNS = (("m", "text"),)

#: batched twins — a leading 0-based request index ``b``; one table holds
#: B independent per-request matrices and ONE rendered plan evaluates all
#: of them (the multi-tenant serving codec)
MATRIX_BATCH_COLUMNS = (("b", "integer"),) + MATRIX_COLUMNS
ARRAY_BATCH_COLUMNS = (("b", "integer"),) + ARRAY_COLUMNS


# ---------------------------------------------------------------------------
# dense ↔ columns / rows
# ---------------------------------------------------------------------------

def matrix_to_columns(x) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense matrix → column vectors ``(i, j, v)`` in canonical row-major
    order, 1-based.  This is the zero-copy-ish form the adapters ingest
    (chunked ``executemany`` on sqlite, Arrow/ndarray registration on
    duckdb)."""
    a = to_host(x)
    if a.ndim != 2:
        raise ValueError(f"expected a matrix, got shape {a.shape}")
    r, c = a.shape
    i = np.repeat(np.arange(1, r + 1, dtype=np.int64), c)
    j = np.tile(np.arange(1, c + 1, dtype=np.int64), r)
    return i, j, a.ravel()


def batch_to_columns(x) -> tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Batched dense stack ``(B, r, c)`` → column vectors ``(b, i, j, v)``:
    ``b`` 0-based request index, ``(i, j)`` 1-based within each request —
    the batched-leaf ingestion form of the multi-tenant serving tier."""
    a = to_host(x)
    if a.ndim != 3:
        raise ValueError(f"expected a (B, rows, cols) stack, got {a.shape}")
    nb, r, c = a.shape
    b = np.repeat(np.arange(nb, dtype=np.int64), r * c)
    i = np.tile(np.repeat(np.arange(1, r + 1, dtype=np.int64), c), nb)
    j = np.tile(np.arange(1, c + 1, dtype=np.int64), nb * r)
    return b, i, j, a.ravel()


def columns_to_rows(i, j, v) -> list[tuple[int, int, float]]:
    """Column vectors → ``[(i, j, v)]`` with native Python scalars.
    ``tolist()`` + ``zip`` run in C — no per-cell Python arithmetic."""
    return list(zip(i.tolist(), j.tolist(), v.tolist()))


def matrix_to_rows(x) -> list[tuple[int, int, float]]:
    """Dense matrix → canonical row-major ``[(i, j, v)]`` (1-based)."""
    return columns_to_rows(*matrix_to_columns(x))


def matrix_to_rows_percell(x) -> list[tuple[int, int, float]]:
    """The original per-cell pivot — one Python iteration (and one
    ``float()`` call) per matrix cell.  Kept only as the ingestion baseline
    for the MNIST-scale benchmark; use :func:`matrix_to_rows`."""
    a = to_host(x)
    if a.ndim != 2:
        raise ValueError(f"expected a matrix, got shape {a.shape}")
    return [(i + 1, j + 1, float(a[i, j]))
            for i in range(a.shape[0]) for j in range(a.shape[1])]


def rows_to_matrix(rows, shape: tuple[int, int]) -> np.ndarray:
    """``[(i, j, v)]`` (1-based, any order, gaps → 0) → dense matrix.

    Missing cells coalesce to 0 — the outer-join semantics of Listing 5's
    one-hot construction.  One fancy-indexed assignment instead of a
    Python loop."""
    out = np.zeros(shape, dtype=np.float64)
    if not len(rows):
        return out
    arr = np.asarray(rows, dtype=np.float64)
    out[arr[:, 0].astype(np.int64) - 1, arr[:, 1].astype(np.int64) - 1] \
        = arr[:, 2]
    return out


# ---------------------------------------------------------------------------
# RelTensor ↔ rows (round-trips the tensor relational representation)
# ---------------------------------------------------------------------------

def reltensor_to_columns(rt: RelTensor
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Valid tuples only, as 1-based column vectors: padding rows
    (``i == shape[0]``) are dropped, just as the inner join drops them
    on-device.  The tensors are read to the host explicitly."""
    i = to_host(rt.i, dtype=np.int64)
    j = to_host(rt.j, dtype=np.int64)
    v = to_host(rt.v)
    keep = i < rt.shape[0]
    return i[keep] + 1, j[keep] + 1, v[keep]


def reltensor_to_rows(rt: RelTensor) -> list[tuple[int, int, float]]:
    return columns_to_rows(*reltensor_to_columns(rt))


def rows_to_reltensor(rows, shape: tuple[int, int],
                      device="cuda") -> RelTensor:
    """Rows → canonical (dense row-major) float32 RelTensor on ``device``."""
    dense = np.asarray(rows_to_matrix(rows, shape), dtype=np.float32)
    return RelTensor.from_dense(torch.as_tensor(dense, device=resolve(device)))


# ---------------------------------------------------------------------------
# adapter-level matrix tables
# ---------------------------------------------------------------------------

def write_matrix(adapter: Adapter, name: str, x, temp: bool = False) -> None:
    """CREATE + bulk-ingest the relation for ``x`` (replacing any old one).

    Ingestion auto-selects per adapter: where the runtime engine expands
    JSON in linear time (``adapter.prefers_json_ingest`` — sqlite ≥ 3.38),
    the pivot moves *into* the engine via ``json_each``
    (``SQLiteAdapter.insert_matrix_json``); everywhere else — including
    sqlite before 3.38, whose ``json_each`` is quadratic — the vectorized
    client pivot + column ingestion stays the default.
    Non-finite values always take the VALUES path (sqlite's JSON parser
    rejects NaN/Infinity tokens).

    ``temp=True`` scopes the relation to this connection (per-shard
    leaves, ``SQLEngine(temp_leaves=True)``): sibling pooled connections
    never see it and their caches are never invalidated by it."""
    a = to_host(x)
    with tracer_of(adapter).span("io.write_matrix", table=name,
                                 cells=int(a.size)):
        adapter.create_table(name, MATRIX_COLUMNS, temp=temp)
        used_json = (getattr(adapter, "prefers_json_ingest", False)
                     and a.ndim == 2 and np.isfinite(a).all())
        if used_json:
            adapter.insert_matrix_json(name, a)
        else:
            adapter.insert_columns(name, matrix_to_columns(a))
        _count_ingest(adapter, a)
    if a.ndim == 2:
        # json_each values round-trip text→real (~1 ulp); the stored cells
        # may then differ from the client copy, so no diff base is kept
        _register_matrix(adapter, name, a, "relational", cache=not used_json)


def write_matrix_batch(adapter: Adapter, name: str, x,
                       temp: bool = True) -> None:
    """CREATE + ingest a batched relational leaf: ``x`` is a ``(B, r, c)``
    stack, the table ``{[b, i, j, v]}``.  Temp by default — batched
    request leaves are per-connection scratch, invisible to (and never
    invalidating) sibling pooled connections."""
    a = to_host(x)
    with tracer_of(adapter).span("io.write_matrix_batch", table=name,
                                 cells=int(a.size),
                                 batch=int(a.shape[0]) if a.ndim else 0):
        adapter.create_table(name, MATRIX_BATCH_COLUMNS, temp=temp)
        adapter.insert_columns(name, batch_to_columns(a))
        _count_ingest(adapter, a)


def write_matrix_array_batch(adapter: Adapter, name: str, x,
                             temp: bool = True) -> None:
    """Batched array-representation leaf: one ``(b, m)`` row per request."""
    a = to_host(x)
    if a.ndim != 3:
        raise ValueError(f"expected a (B, rows, cols) stack, got {a.shape}")
    with tracer_of(adapter).span("io.write_matrix_array_batch", table=name,
                                 cells=int(a.size), batch=int(a.shape[0])):
        adapter.create_table(name, ARRAY_BATCH_COLUMNS, temp=temp)
        adapter.bulk_insert(name, [(k, matrix_to_json(a[k]))
                                   for k in range(a.shape[0])])
        _count_ingest(adapter, a)


def write_matrix_json(adapter: Adapter, name: str, x) -> None:
    """The JSON-array ingestion path (``SQLiteAdapter.insert_matrix_json``):
    the (i, j, v) expansion happens inside the engine via ``json_each``.
    Values may differ from the source by ~1 ulp (sqlite's text→real)."""
    if not adapter.supports_json_ingest:
        raise NotImplementedError(
            f"{type(adapter).__name__} has no table-valued JSON ingestion")
    adapter.create_table(name, MATRIX_COLUMNS)
    adapter.insert_matrix_json(name, to_host(x))


def write_matrix_percell(adapter: Adapter, name: str, x) -> None:
    """The pre-vectorization ingestion path (per-cell pivot + one flat
    ``executemany``) — the benchmark baseline."""
    adapter.create_table(name, MATRIX_COLUMNS)
    adapter.bulk_insert(name, matrix_to_rows_percell(x))


def read_matrix(adapter: Adapter, name: str,
                shape: tuple[int, int]) -> np.ndarray:
    rows = adapter.execute(f"select i, j, v from {_check_ident(name)}")
    return rows_to_matrix(rows, shape)


def write_matrix_array(adapter: Adapter, name: str, x,
                       temp: bool = False) -> None:
    """CREATE + ingest ``x`` in the *array* representation: one row, one
    array-typed (JSON codec) column — the leaf layout the ``array`` dialect
    renders against (``SQLEngine(dialect="array")``).  ``temp=True`` as in
    :func:`write_matrix`."""
    a = to_host(x)
    with tracer_of(adapter).span("io.write_matrix_array", table=name,
                                 cells=int(a.size)):
        adapter.create_table(name, ARRAY_COLUMNS, temp=temp)
        adapter.bulk_insert(name, [(matrix_to_json(a),)])
        _count_ingest(adapter, a)
    if a.ndim == 2:
        _register_matrix(adapter, name, a, "array", cache=False)


def update_matrix_delta(adapter: Adapter, name: str, x) -> int | None:
    """Bound-parameter in-place refresh of a RESIDENT relational matrix.

    Returns the number of value bytes actually rebound, or ``None`` when
    the relation is not resident with a matching shape (caller falls back
    to :func:`write_matrix`).  Small leaves (``DELTA_MAX_CELLS``) diff
    against the retained client copy and UPDATE only the changed cells
    through one prepared statement (``adapter.update_cells``); larger
    resident relations are rewritten in place — DELETE + re-insert keeps
    the table object, its schema and sqlite3's cached INSERT statement,
    instead of the DROP/CREATE churn of a full write."""
    a = to_host(x)
    if a.ndim != 2 or adapter.matrix_meta.get(name) != ("relational",
                                                        a.shape):
        return None
    if not adapter.cache_fresh(name):
        # a sibling pooled connection rewrote the relation since our copy
        # was recorded — patching cells on top of ITS content would write
        # a silent mix of two matrices; drop our caches (no generation
        # bump: the resident content is valid) and force the full path
        adapter.forget(name)
        return None
    prev = adapter.matrix_cache.get(name)
    tr = tracer_of(adapter)
    if prev is not None and 0 < a.size <= DELTA_MAX_CELLS:
        # NaN compares unequal to itself, so non-finite cells always
        # re-bind — conservative and round-trip-identical to a full write
        changed = np.flatnonzero(a.ravel() != prev.ravel())
        with tr.span("io.update_matrix", table=name, mode="delta",
                     cells=int(changed.size)):
            if changed.size:
                adapter.update_cells(name, changed, a.ravel()[changed],
                                     a.shape)
        _register_matrix(adapter, name, a, "relational")
        adapter.add_counters(delta_updates=1,
                             ingest_bytes=int(changed.size) * 8,
                             ingest_cells=int(changed.size))
        return int(changed.size) * 8
    with tr.span("io.update_matrix", table=name, mode="rewrite",
                 cells=int(a.size)):
        adapter.execute(f"delete from {_check_ident(name)}")
        adapter.insert_columns(name, matrix_to_columns(a))
    _register_matrix(adapter, name, a, "relational")
    _count_ingest(adapter, a)
    return int(a.nbytes)


def update_matrix_array(adapter: Adapter, name: str, x) -> bool:
    """Single-row bound-parameter refresh of an array-representation leaf
    — ``update ... set m = ?`` against the resident row instead of
    DROP/CREATE/INSERT.  True when the in-place update applied."""
    a = to_host(x)
    if a.ndim != 2 or adapter.matrix_meta.get(name) != ("array", a.shape):
        return False
    if not adapter.cache_fresh(name):
        adapter.forget(name)  # sibling write — see update_matrix_delta
        return False
    with tracer_of(adapter).span("io.update_matrix_array", table=name,
                                 cells=int(a.size)):
        adapter.execute(
            f"update {_check_ident(name)} set m = {adapter.placeholder}",
            (matrix_to_json(a),))
    adapter.bump_gen(name)  # content changed under sibling caches
    _register_matrix(adapter, name, a, "array", cache=False)
    adapter.add_counters(delta_updates=1)
    _count_ingest(adapter, a)
    return True


def read_matrix_array(adapter: Adapter, name: str) -> np.ndarray:
    rows = adapter.execute(f"select m from {_check_ident(name)}")
    return json_to_matrix(rows[0][0])


# ---------------------------------------------------------------------------
# cross-connection gradient shipping (the AllReduce input of db/shard.py)
# ---------------------------------------------------------------------------

#: coordinator-side gradient relation: ``r`` the multi-root tag of the
#: shard plan's result rows (1.. = the wrt weights, in order), ``s`` the
#: shard index — the SQL AllReduce groups on (r, i, j) across ``s``
SHARD_GRAD_COLUMNS = (("r", "integer"), ("s", "integer")) + MATRIX_COLUMNS

#: array-representation twin: one codec row per (weight, shard)
SHARD_GRAD_ARRAY_COLUMNS = (("r", "integer"), ("s", "integer")) + ARRAY_COLUMNS


def create_shard_grads(adapter: Adapter, name: str, representation: str,
                       temp: bool = True) -> None:
    """The coordinator's gradient landing relation (temp by default — it
    is per-coordinator scratch, rebuilt every step)."""
    cols = (SHARD_GRAD_COLUMNS if representation == "relational"
            else SHARD_GRAD_ARRAY_COLUMNS)
    adapter.create_table(name, cols, temp=temp)


def ship_grad_rows(adapter: Adapter, name: str, shard: int, rows,
                   representation: str, grad_roots_from: int = 1) -> int:
    """Import one shard's tagged multi-root result rows (the raw output of
    ``SQLEngine.evaluate_rows``) into the coordinator's gradient relation,
    stamped with the shard index — the export/import half of the SQL
    AllReduce.  Rows tagged below ``grad_roots_from`` (the loss root) are
    not gradients and are skipped.  Returns the number of rows shipped.
    The rows are database values already (host tuples), never tensors."""
    kept = [row for row in rows if row[0] >= grad_roots_from]
    n = len(kept)
    with tracer_of(adapter).span("io.ship_grads", table=name, shard=shard,
                                 rows=n):
        if not n:
            return 0
        if representation == "relational":
            arr = np.asarray(kept, dtype=np.float64)
            adapter.insert_columns(name, (
                arr[:, 0].astype(np.int64),
                np.full(n, shard, dtype=np.int64),
                arr[:, 1].astype(np.int64),
                arr[:, 2].astype(np.int64),
                arr[:, 3]))
        else:
            adapter.bulk_insert(name, [(int(r), shard, m)
                                       for r, m in kept])
        adapter.add_counters(shipped_rows=n)
    return n


def write_reltensor(adapter: Adapter, name: str, rt: RelTensor) -> None:
    with tracer_of(adapter).span("io.write_reltensor", table=name):
        adapter.create_table(name, MATRIX_COLUMNS)
        i, j, v = reltensor_to_columns(rt)
        adapter.insert_columns(name, (i, j, v))
        _count_ingest(adapter, v)


def read_reltensor(adapter: Adapter, name: str, shape: tuple[int, int],
                   device="cuda") -> RelTensor:
    rows = adapter.execute(f"select i, j, v from {_check_ident(name)}")
    return rows_to_reltensor(rows, shape, device)
