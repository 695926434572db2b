"""The backend-agnostic adapter contract.

An :class:`Adapter` owns a prepared connection plus the matching
:mod:`repro_torch.db.dialect`, and exposes exactly what the execution backend
needs: ``execute`` (rows back), ``create_table``, ``bulk_insert`` and the
vectorized ``insert_columns``.  Everything else (SQL rendering, array
pivoting) lives in ``dialect`` / ``relation_io`` so the adapters stay thin.

The contract a backend module (``sqlite.py`` / ``duckdb.py`` /
``postgres.py``) fills in:

* **statement execution** — ``_execute_raw`` / ``_executemany_raw`` are the
  only two places a raw connection runs SQL; DB-API modules without a
  connection-level ``execute`` (psycopg2) override just these, and the
  traced/locked/counted ``execute`` / ``executemany`` wrappers stay shared.
* **param style** — ``placeholder`` / ``paramstyle``: every statement the
  shared code renders uses ``self.placeholder``, so qmark (sqlite, duckdb)
  and format (postgres) backends ride identical call sites.
* **ingestion** — ``insert_columns`` (vectorized bulk path; backends
  override with multi-row VALUES / Arrow registration / execute_values),
  optional ``insert_matrix_json`` behind ``supports_json_ingest`` /
  ``prefers_json_ingest``.
* **temp tables** — ``create_table(temp=True)`` scopes a relation to this
  connection; ``supports_temp_tables`` advertises it (all three backends).
* **UDF capability** — ``supports_python_udfs``: whether the connection can
  register Python scalar functions (sqlite/duckdb yes; postgres runs
  server-side and plpython-free, so the array representation's UDF zoo is
  unavailable there and callers must stay on pure-SQL relational paths).

Both matrix representations ride the same methods: cell-relational
``{[i, j, v]}`` tables through ``insert_columns``, array-representation
tables (ONE row, a JSON array-typed ``m`` column —
``relation_io.ARRAY_COLUMNS``) through ``bulk_insert``; ``matrix_digests``
entries embed the representation, so an engine switch on a shared
connection always rewrites the leaf.
"""
from __future__ import annotations

import itertools
import logging
import os
import re
import threading
import time
from typing import Iterable, Sequence

import numpy as np

from ...obs import tracer_of
from ..dialect import Sql92Dialect

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

#: rows per executemany chunk (bounds peak Python-object materialisation)
CHUNK_ROWS = 100_000

#: queries slower than this many milliseconds are logged (rendered SQL head
#: + span path) through the ``repro_torch.db`` logger; unset/invalid → disabled
SLOW_QUERY_ENV = "REPRO_SLOW_QUERY_MS"

#: characters of rendered SQL attached to spans and slow-query log lines
SQL_HEAD = 160

log = logging.getLogger("repro_torch.db")


def _slow_threshold_s() -> float | None:
    """Parse ``REPRO_SLOW_QUERY_MS`` (read per query so tests and running
    processes can flip it); None disables the slow-query log."""
    v = os.environ.get(SLOW_QUERY_ENV)
    if not v:
        return None
    try:
        return float(v) / 1e3
    except ValueError:
        return None


def _check_ident(name: str) -> str:
    if not _IDENT.match(name):
        raise ValueError(f"bad SQL identifier: {name!r}")
    return name


#: process-wide table-generation registry: (db_key, table) → generation,
#: bumped by every structured mutation through ANY adapter of the same
#: logical database.  Pooled connections on one file see each other's
#: writes, so per-adapter caches (``matrix_cache`` / ``matrix_digests`` /
#: ``matrix_meta``) are trustworthy only while the generation they were
#: recorded at (``Adapter.matrix_gen``) still matches — the fix for the
#: two-connection stale-delta bug (``update_matrix_delta`` patching cells
#: on top of a sibling's rewrite).
_GEN_LOCK = threading.Lock()
_TABLE_GEN: dict[tuple[str, str], int] = {}
#: unique per-adapter token for non-shared registry keys (``:memory:``
#: databases, temp-table namespaces).  A plain ``id(self)`` is NOT unique
#: over time — CPython reuses addresses, so a fresh ``:memory:`` adapter
#: could inherit a dead sibling's generations/digests and "adopt" tables
#: it never wrote
_CONN_SEQ = itertools.count()
#: (db_key, table) → content digest as last written by ANY adapter.  A
#: pooled worker about to ingest a leaf whose digest already matches can
#: ADOPT the resident table instead of rewriting it — without this, two
#: workers alternating on one shared weight relation would invalidate each
#: other forever (write ping-pong).  Popped on every generation bump.
_TABLE_DIGEST: dict[tuple[str, str], bytes] = {}


class Adapter:
    """Base adapter: a prepared connection + its dialect."""

    dialect: Sql92Dialect
    #: literal spliced into rendered statements for one bound parameter
    placeholder = "?"
    #: DB-API paramstyle the placeholder belongs to ("qmark" / "format") —
    #: informational companion to ``placeholder`` for contract tests
    paramstyle = "qmark"
    #: whether ``create_table(temp=True)`` yields a connection-scoped table
    supports_temp_tables = True
    #: whether Python scalar functions can be registered on the connection
    #: (False on server-side backends — postgres — where the array
    #: representation's UDF zoo cannot run)
    supports_python_udfs = True
    #: whether ``insert_matrix_json`` (engine-side json_each expansion) is
    #: available — probed per connection where the backend supports it
    supports_json_ingest = False
    #: whether the engine-side JSON path should be the *default* matrix
    #: ingestion (``relation_io.write_matrix`` consults this) — only where
    #: the runtime engine expands JSON in linear time
    prefers_json_ingest = False

    def __init__(self, conn):
        self.conn = conn
        #: table → content digest of the matrix it stores, maintained by
        #: SQLEngine's leaf ingestion.  Lives on the adapter (not the
        #: engine) so every adapter-level mutation of a table — replace
        #: via create_table or append via bulk_insert/insert_columns, e.g.
        #: db.train writing `img` directly — invalidates the entry, and
        #: engines sharing one connection share the skip.  (Raw
        #: ``execute`` writes are untracked: mutate matrix tables through
        #: the structured methods.)
        self.matrix_digests: dict[str, bytes] = {}
        #: table → (representation, shape) of the matrix it stores — what
        #: the bound-parameter delta path (``relation_io.update_matrix_*``)
        #: checks before updating a resident relation in place
        self.matrix_meta: dict[str, tuple] = {}
        #: table → retained client-side copy of SMALL relational matrices
        #: (``relation_io.DELTA_MAX_CELLS`` gate) — the diff base that turns
        #: a leaf refresh into a prepared UPDATE of only the changed cells
        self.matrix_cache: dict[str, np.ndarray] = {}
        #: table → generation (``table_gen``) at which the caches above
        #: were recorded; ``cache_fresh`` compares it against the shared
        #: registry before any of them is trusted
        self.matrix_gen: dict[str, int] = {}
        #: tracer override for this connection's spans (None → the
        #: module-level active tracer, a no-op unless installed)
        self.tracer = None
        #: serializes ALL raw-connection access AND counter updates —
        #: sqlite connections opened ``check_same_thread=False`` and duckdb
        #: cursors are handed across pool-worker threads; re-entrant so
        #: span-wrapped fast paths may nest ``execute`` calls
        self.lock = threading.RLock()
        #: identity of the logical database for the shared generation
        #: registry; file-backed adapters override with a path key so
        #: sibling connections on one file share generations.  The token
        #: is a process-lifetime-unique sequence number, never id()
        self._conn_token = next(_CONN_SEQ)
        self._db_key = f"conn:{self._conn_token}"
        #: tables created ``temp=True`` — per-connection namespace, keyed
        #: per-adapter in the registry so temp churn never invalidates
        #: sibling connections
        self._temp_tables: set[str] = set()
        #: always-on cheap counters, merged into ``SQLEngine.stats``;
        #: mutate through ``add_counters`` (or under ``self.lock``) — plain
        #: ``+=`` from pool workers drops increments
        self.counters: dict[str, int] = {
            "queries": 0, "statements": 0, "rows_returned": 0,
            "ingest_bytes": 0, "ingest_cells": 0, "slow_queries": 0,
        }
        self.dialect.prepare(conn)

    # -- cross-connection cache coherence -----------------------------------
    def _gen_key(self, name: str) -> tuple[str, str]:
        """Registry key for a table: temp tables are invisible to sibling
        connections, so they key per-adapter; everything else keys per
        logical database."""
        if name in self._temp_tables:
            return (f"tmp:{self._conn_token}", name)
        return (self._db_key, name)

    def table_gen(self, name: str) -> int:
        with _GEN_LOCK:
            return _TABLE_GEN.get(self._gen_key(name), 0)

    def bump_gen(self, name: str) -> None:
        """Advance the table's shared generation (and drop its shared
        digest): every sibling adapter's caches for it become stale."""
        with _GEN_LOCK:
            k = self._gen_key(name)
            _TABLE_GEN[k] = _TABLE_GEN.get(k, 0) + 1
            _TABLE_DIGEST.pop(k, None)

    def cache_fresh(self, name: str) -> bool:
        """Were this adapter's cached digest/meta/diff-copy for ``name``
        recorded at the table's CURRENT generation?  False the moment any
        sibling adapter on the same database mutates the relation."""
        gen = self.matrix_gen.get(name)
        return gen is not None and gen == self.table_gen(name)

    def shared_digest(self, name: str) -> bytes | None:
        with _GEN_LOCK:
            return _TABLE_DIGEST.get(self._gen_key(name))

    def record_digest(self, name: str, digest: bytes) -> None:
        with _GEN_LOCK:
            _TABLE_DIGEST[self._gen_key(name)] = digest

    def add_counters(self, **deltas: int) -> None:
        """Locked read-modify-write of the always-on counters — exact
        totals even when pool workers ingest concurrently."""
        with self.lock:
            for k, v in deltas.items():
                self.counters[k] = self.counters.get(k, 0) + v

    # -- statement execution ------------------------------------------------
    #
    # EVERY statement the backend runs goes through ``execute`` /
    # ``executemany`` (or the span-wrapped fast paths in the backend
    # modules), so span coverage and the query counters cannot be bypassed
    # by new call sites — ``tests/test_obs_coverage.py`` statically
    # enforces both halves.  ``_execute_raw`` / ``_executemany_raw`` are
    # the client seam: they run ONLY under the span+lock of the wrappers.

    def _execute_raw(self, sql: str, params: Sequence):
        """Run one statement on the raw connection, return a cursor-like
        with ``fetchall``.  Backends whose DB-API module lacks a connection-level
        ``execute`` (psycopg2) override this single method."""
        # obs: exempt — client seam; only ever called under the span and
        # lock of Adapter.execute
        return self.conn.execute(sql, tuple(params))

    def _executemany_raw(self, sql: str, rows: Iterable[Sequence]) -> None:
        # obs: exempt — client seam; only ever called under the span and
        # lock of Adapter.executemany
        self.conn.executemany(sql, rows)

    def _finish_stmt(self, sql: str, dt: float, tracer) -> None:
        """Shared statement epilogue: slow-query log (``REPRO_SLOW_QUERY_MS``)
        with the rendered SQL head and the innermost span path."""
        thr = _slow_threshold_s()
        if thr is not None and dt >= thr:
            self.counters["slow_queries"] += 1
            head = " ".join(sql[:SQL_HEAD].split())
            log.warning("slow query %.1f ms (>= %s ms) span=%s sql=%s",
                        dt * 1e3, os.environ.get(SLOW_QUERY_ENV),
                        tracer.current_path() or "<untraced>", head)

    def execute(self, sql: str, params: Sequence = ()) -> list[tuple]:
        """Run one statement, return all result rows (possibly empty).
        Serialized on ``self.lock`` — one connection, many threads."""
        tr = tracer_of(self)
        with tr.span("db.execute") as sp, self.lock:
            t0 = time.perf_counter()
            cur = self._execute_raw(sql, params)
            try:
                rows = cur.fetchall()
            except Exception:  # statement without a result set
                rows = []
            dt = time.perf_counter() - t0
            self.counters["queries"] += 1
            self.counters["rows_returned"] += len(rows)
            if tr.enabled:
                sp.set(sql=" ".join(sql[:SQL_HEAD].split()), rows=len(rows))
                tr.observe("db.execute_ms", dt * 1e3)
            self._finish_stmt(sql, dt, tr)
        return rows

    def executemany(self, sql: str, rows: Iterable[Sequence]) -> None:
        tr = tracer_of(self)
        with tr.span("db.executemany") as sp, self.lock:
            t0 = time.perf_counter()
            self._executemany_raw(sql, rows)
            dt = time.perf_counter() - t0
            self.counters["statements"] += 1
            if tr.enabled:
                sp.set(sql=" ".join(sql[:SQL_HEAD].split()))
            self._finish_stmt(sql, dt, tr)

    # -- introspection ------------------------------------------------------
    def explain_sql(self, sql: str) -> str:
        """The engine's plan for ``sql`` as text ('' where unsupported) —
        captured once per cached plan by ``SQLEngine`` and stored alongside
        the plan-cache entry."""
        return ""

    def db_bytes(self) -> int | None:
        """Stored size of the database in bytes (None where unknowable) —
        the ``db_bytes`` delta attribute of evaluation spans."""
        return None

    # -- schema / data ------------------------------------------------------
    def forget(self, name: str) -> None:
        """Drop THIS adapter's caches for a table without advancing the
        shared generation — used when this adapter discovers its caches
        are stale: the resident content is a sibling's valid write, and
        bumping here would ping-pong invalidations between workers."""
        self.matrix_digests.pop(name, None)
        self.matrix_meta.pop(name, None)
        self.matrix_cache.pop(name, None)
        self.matrix_gen.pop(name, None)

    def _invalidate(self, name: str) -> None:
        """Forget everything cached about a matrix table — content digest,
        shape metadata and the client-side diff copy — so any structured
        mutation of the relation disables the unchanged-leaf skip AND the
        bound-parameter delta path until the next full registration.  Also
        advances the table's shared generation: sibling pooled adapters'
        caches go stale with ours."""
        self.forget(name)
        self.bump_gen(name)

    def create_table(self, name: str, columns: Sequence[tuple[str, str]],
                     replace: bool = True, temp: bool = False) -> None:
        """``columns`` is [(col_name, sql_type), ...].  ``temp=True``
        creates a per-connection temp table (batched request leaves, shard
        partitions): invisible to sibling connections, so its generation is
        keyed per-adapter and never invalidates their caches."""
        _check_ident(name)
        was_temp = name in self._temp_tables
        if replace and not temp and was_temp:
            # a temp table shadows the main-schema name on this
            # connection: DROP resolves to the shadow, so one drop below
            # would leave the resident main table colliding with CREATE
            self.execute(f"drop table if exists {name}")
        if temp:
            self._temp_tables.add(name)
        else:
            self._temp_tables.discard(name)
        self._invalidate(name)
        cols = ", ".join(f"{_check_ident(c)} {t}" for c, t in columns)
        kw = "temp table" if temp else "table"
        # creating a temp table over a name we never temp-created must NOT
        # drop first: unqualified DROP would resolve to (and destroy) the
        # MAIN relation the temp twin is supposed to shadow
        if replace and (not temp or was_temp):
            self.execute(f"drop table if exists {name}")
        self.execute(f"create {kw} {name} ({cols})")

    def bulk_insert(self, name: str, rows: Iterable[Sequence]) -> None:
        self._invalidate(name)
        rows = list(rows)
        if not rows:
            return
        ph = ", ".join([self.placeholder] * len(rows[0]))
        self.executemany(f"insert into {_check_ident(name)} values ({ph})",
                         rows)

    def _prepare_columns(self, name: str, cols: Sequence,
                         dtype=None) -> tuple[list[np.ndarray], int]:
        """Shared ``insert_columns`` preamble: identifier check, digest
        invalidation, array conversion, equal-length validation.  Returns
        ``(columns, n_rows)``; ``n_rows == 0`` means nothing to insert."""
        _check_ident(name)
        self._invalidate(name)
        cols = [np.asarray(c) if dtype is None else np.asarray(c, dtype)
                for c in cols]
        n = cols[0].shape[0] if cols else 0
        if n and any(c.shape != (n,) for c in cols):
            raise ValueError("insert_columns needs equal-length 1-D columns")
        return cols, n

    def insert_columns(self, name: str,
                       cols: Sequence[np.ndarray]) -> None:
        """Vectorized bulk ingestion: one ndarray per column, equal length.

        Generic implementation: chunked ``executemany`` over ``zip`` of
        ``tolist()`` slices — conversion to Python scalars happens in C,
        never per-cell in Python.  Backends override with faster native
        paths."""
        cols, n = self._prepare_columns(name, cols)
        if not n:
            return
        ph = ", ".join([self.placeholder] * len(cols))
        sql = f"insert into {name} values ({ph})"
        for s in range(0, n, CHUNK_ROWS):
            e = min(n, s + CHUNK_ROWS)
            self.executemany(sql, zip(*(c[s:e].tolist() for c in cols)))

    def update_cells(self, name: str, flat_index: np.ndarray,
                     values: np.ndarray, shape: Sequence[int]) -> None:
        """Bound-parameter in-place update of individual matrix cells,
        addressed by 0-based canonical row-major flat index — the prepared
        statement behind the small-leaf delta ingestion path.  Generic
        spelling keys on the (i, j) columns; sqlite overrides with the
        rowid fast path."""
        _check_ident(name)
        self.matrix_digests.pop(name, None)
        self.bump_gen(name)
        cols = int(shape[1])
        i = (flat_index // cols + 1).tolist()
        j = (flat_index % cols + 1).tolist()
        self.executemany(
            f"update {name} set v = {self.placeholder} where"
            f" i = {self.placeholder} and j = {self.placeholder}",
            zip(values.tolist(), i, j))

    # -- lifecycle ----------------------------------------------------------
    def commit(self) -> None:
        with self.lock:
            self.conn.commit()

    def close(self) -> None:
        with self.lock:
            try:  # flush pending inserts — sqlite3 rolls back open txns
                self.conn.commit()
            except Exception:  # pragma: no cover - autocommit (duckdb)
                pass
            self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
