"""The stdlib ``sqlite3`` backend — always available, the default.

Ingestion strategy (the MNIST-scale bottleneck — see
``benchmarks/bench_mnist_db.py``): multi-row ``INSERT … VALUES (…),(…),…``
batches (fewer statement steps; ~3× over the flat per-cell path, which is
the floor the row-at-a-time storage model allows), with engine-side
``json_each`` expansion auto-selected on ≥ 3.38 builds where the JSON
table-functions are linear."""
from __future__ import annotations

import os
import sqlite3
from typing import Sequence

import numpy as np

from ...obs import tracer_of
from ..dialect import SqliteDialect
from .base import Adapter, _check_ident


class SQLiteAdapter(Adapter):
    dialect = SqliteDialect()

    #: rows per multi-row VALUES statement; sqlite's bound-parameter limit
    #: is 999 on older builds — 300 rows × 3 cols stays under it
    ROWS_PER_STMT = 300

    #: first sqlite release whose JSON table-functions extract values in
    #: linear time (the 3.38 JSON rewrite); before it ``json_each`` is
    #: O(array length) per row and the engine-side parse loses to VALUES
    #: (measured on sqlite 3.34 by the JAX package's ``bench_mnist_db.py``)
    JSON_LINEAR_VERSION = (3, 38)

    #: milliseconds a statement waits on a sibling connection's write lock
    #: before ``database is locked`` — generous: pool writers serialize
    BUSY_TIMEOUT_MS = 30_000

    def __init__(self, path: str = ":memory:"):
        # check_same_thread=False: the adapter serializes every raw-
        # connection access on ``self.lock``, so handing the connection
        # across pool-worker threads is safe — sqlite's own affinity check
        # would raise ProgrammingError on the first cross-thread call
        super().__init__(sqlite3.connect(
            path, timeout=self.BUSY_TIMEOUT_MS / 1e3,
            check_same_thread=False))
        self.path = path
        if path != ":memory:":
            # sibling connections on one file share table generations
            self._db_key = "sqlite:" + os.path.abspath(path)
        #: runtime engine version — instance-level so tests can pin it
        self.sqlite_version = sqlite3.sqlite_version_info
        try:  # table-valued JSON ingestion needs the (default) JSON1 ext.
            # obs: exempt — capability probe at connect time, not a query
            self.conn.execute("select count(*) from json_each('[0]')")
            self.supports_json_ingest = True
        except sqlite3.Error:  # pragma: no cover - JSON1-less builds
            self.supports_json_ingest = False
        try:
            # obs: exempt — connection-mode pragmas at open, not queries
            self.conn.execute(f"pragma busy_timeout = {self.BUSY_TIMEOUT_MS}")
            if path != ":memory:":
                # WAL: many concurrent readers + one writer across the
                # pool's connections (a rollback-journal DB serializes
                # readers behind any writer)
                self.conn.execute("pragma journal_mode = wal")
        except sqlite3.Error:  # pragma: no cover - locked-down builds
            pass

    @property
    def prefers_json_ingest(self) -> bool:
        """Auto-select the engine-side ``json_each`` ingestion on builds
        where it is linear (≥ :data:`JSON_LINEAR_VERSION`); older engines
        keep the multi-row VALUES batching."""
        return (self.supports_json_ingest
                and self.sqlite_version >= self.JSON_LINEAR_VERSION)

    def explain_sql(self, sql: str) -> str:
        """``EXPLAIN QUERY PLAN`` rows as ``id parent: detail`` lines."""
        try:
            rows = self.execute("explain query plan " + sql)
        except Exception:
            return ""
        return "\n".join(f"{r[0]} {r[1]}: {r[-1]}" for r in rows)

    def db_bytes(self) -> int | None:
        try:
            # obs: exempt — size probe read by the tracer itself; spanning
            # it would pollute every evaluation trace with pragma queries
            with self.lock:
                page_count, = (self.conn.execute("pragma page_count")
                               .fetchone())
                page_size, = (self.conn.execute("pragma page_size")
                              .fetchone())
            return int(page_count) * int(page_size)
        except Exception:  # pragma: no cover - pragma-less builds
            return None

    #: cells per bound JSON array.  sqlite ≤3.37 extracts json_each values
    #: in O(array length) per row — one giant array is quadratic; bounded
    #: chunks keep the parse cost linear (and the win grows on ≥3.38
    #: builds, whose JSON table-functions are linear outright).
    JSON_CHUNK_CELLS = 4096

    def insert_matrix_json(self, name: str, x: np.ndarray) -> None:
        """JSON-array ingestion (the ROADMAP's table-valued lever): bind
        row-major JSON array chunks and let the engine expand them with the
        ``json_each`` table-valued function — index arithmetic on ``key``
        recovers the 1-based (i, j) pivot *inside* sqlite, eliminating the
        per-row Python binding of the VALUES path.  Values round-trip
        through sqlite's text→real parse, which may differ by ~1 ulp from
        the bound double (on sqlite 3.34 the engine-side parse roughly
        cancels the client-side saving — the lever pays off on
        JSON-optimised ≥ 3.38 builds)."""
        import json

        _check_ident(name)
        self._invalidate(name)
        a = np.asarray(x, dtype=np.float64)
        if a.ndim != 2:
            raise ValueError(f"expected a matrix, got shape {a.shape}")
        if not np.isfinite(a).all():
            # json.dumps would emit NaN/Infinity tokens, which sqlite's
            # JSON parser rejects mid-chunk (partial table); refuse up
            # front — the VALUES path (write_matrix) binds them fine
            raise ValueError("non-finite values cannot ride the JSON "
                             "ingestion path; use write_matrix")
        cols = a.shape[1]
        flat = a.reshape(-1)
        chunk = max(cols, (self.JSON_CHUNK_CELLS // cols) * cols)
        sql = (f"insert into {name} "
               f"select (key + ?) / {cols} + 1, key % {cols} + 1, value "
               f"from json_each(?)")
        tr = tracer_of(self)
        with tr.span("db.ingest_json", table=name, cells=int(a.size)), \
                self.lock:
            cur = self.conn.cursor()
            for s in range(0, flat.size, chunk):
                cur.execute(sql, (s, json.dumps(flat[s:s + chunk].tolist())))
                self.counters["statements"] += 1

    def insert_columns(self, name: str,
                       cols: Sequence[np.ndarray]) -> None:
        """Multi-row VALUES batching: one statement binds ROWS_PER_STMT
        rows, executemany streams the batches.  Parameters are interleaved
        into one flat float list by strided ndarray assignment (ints bind
        fine through float64 — sqlite is dynamically typed and the matrix
        schema only ever compares/joins on equality of exact small ints)."""
        cols, n = self._prepare_columns(name, cols, dtype=np.float64)
        if not n:
            return
        k = len(cols)
        flat = np.empty(n * k)
        for ci, c in enumerate(cols):
            flat[ci::k] = c
        flat = flat.tolist()
        row_ph = "(" + ", ".join(["?"] * k) + ")"
        # never exceed 999 bound parameters per statement, whatever the
        # column count (wider tables than {i,j,v} pass through here too)
        batch = max(1, min(self.ROWS_PER_STMT, 999 // k))
        full, rem = divmod(n, batch)
        tr = tracer_of(self)
        with tr.span("db.ingest_values", table=name, rows=n), self.lock:
            cur = self.conn.cursor()
            if full:
                stride = k * batch
                sql = (f"insert into {name} values "
                       + ", ".join([row_ph] * batch))
                cur.executemany(sql, (flat[s:s + stride]
                                      for s in range(0, full * stride,
                                                     stride)))
                self.counters["statements"] += 1
            if rem:
                sql = (f"insert into {name} values "
                       + ", ".join([row_ph] * rem))
                cur.execute(sql, flat[full * batch * k:])
                self.counters["statements"] += 1

    def update_cells(self, name: str, flat_index: np.ndarray,
                     values: np.ndarray, shape: Sequence[int]) -> None:
        """The rowid fast path: matrix tables are populated in canonical
        row-major order (``relation_io.matrix_to_columns``) and the delta
        path never deletes individual rows, so ``rowid == flat_index + 1``
        — one prepared two-parameter UPDATE per changed cell, no (i, j)
        predicate evaluation."""
        _check_ident(name)
        self.matrix_digests.pop(name, None)
        self.bump_gen(name)
        self.executemany(f"update {name} set v = ? where rowid = ?",
                         zip(values.tolist(), (flat_index + 1).tolist()))
