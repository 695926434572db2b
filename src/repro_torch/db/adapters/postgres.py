"""The postgres backend — a psycopg2 session against a running server.

Unlike the embedded engines, postgres is client/server: the adapter holds
one session, identified by a libpq DSN (``connect("postgres", dsn)`` or the
``REPRO_PG_DSN`` environment variable, which points a test run at a
server).  Differences the contract absorbs:

* **param style** — psycopg2 is ``format`` (``%s``); every shared call
  site renders through ``Adapter.placeholder``.
* **no connection-level execute** — psycopg2 runs statements on cursors;
  only the ``_execute_raw`` / ``_executemany_raw`` seams are overridden,
  so the traced/locked/counted wrappers are untouched.
* **autocommit** — a failed statement would otherwise poison the session
  transaction (``InFailedSqlTransaction`` on every later statement, where
  sqlite/duckdb recover per-statement); autocommit matches their
  semantics.
* **no Python UDFs** — ``supports_python_udfs = False``: the server is
  plpython-free, so only pure-SQL paths (the relational representation,
  the sql92/window-function dialect machinery) run here.  The array-UDF
  zoo and Listing-7-style single-CTE recursion (postgres rejects the
  recursive self-reference inside a subquery) are unavailable; training
  uses the stepped strategy.
* **temp tables** — ``create temp table`` is session-scoped and shadows
  the main schema via ``pg_temp`` leading the search path: exactly the
  shadowing semantics the shared ``create_table`` logic assumes.

Ingestion uses ``psycopg2.extras.execute_values`` — one multi-row VALUES
statement per page, psycopg2's bulk path."""
from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from ...obs import tracer_of
from ..dialect import PostgresDialect
from .base import Adapter, _check_ident

try:  # pragma: no cover - depends on environment
    import psycopg2
    HAVE_PSYCOPG2 = True
except ImportError:  # pragma: no cover - psycopg2 not installed
    psycopg2 = None
    HAVE_PSYCOPG2 = False

#: libpq DSN used when ``connect("postgres")`` is called without one —
#: how a test run points the suite at a postgres server
PG_DSN_ENV = "REPRO_PG_DSN"


def resolve_dsn(dsn: str | None = None) -> str:
    """An explicit DSN wins; ``None`` / ``""`` / ``":memory:"`` (the
    path-argument defaults of ``connect``/``ConnectionPool``) fall back to
    ``REPRO_PG_DSN``."""
    if dsn and dsn != ":memory:":
        return dsn
    env = os.environ.get(PG_DSN_ENV, "")
    if not env:
        raise ValueError(
            "postgres backend needs a DSN: pass one as the path argument "
            f"or set {PG_DSN_ENV}")
    return env


class PostgresAdapter(Adapter):  # pragma: no cover - needs a server
    placeholder = "%s"
    paramstyle = "format"
    supports_python_udfs = False

    #: rows per multi-row VALUES page in ``execute_values``
    PAGE_SIZE = 1000

    def __init__(self, dsn: str | None = None):
        if not HAVE_PSYCOPG2:
            raise ImportError(
                "psycopg2 is not installed; use backend='sqlite' or "
                "pip install psycopg2-binary")
        self.dialect = PostgresDialect()
        self.dsn = resolve_dsn(dsn)
        conn = psycopg2.connect(self.dsn)
        conn.autocommit = True
        super().__init__(conn)
        # sibling sessions on one DSN share a catalog (and generations);
        # temp tables stay per-adapter through _temp_tables as everywhere
        self._db_key = "postgres:" + self.dsn

    def _execute_raw(self, sql: str, params: Sequence):
        # obs: exempt — client seam under Adapter.execute's span+lock;
        # psycopg2 has no connection-level execute, statements run on
        # cursors.  params=None when empty: with a (possibly empty)
        # params sequence psycopg2 %-interpolates the SQL, and rendered
        # plans legitimately contain % (modulo arithmetic)
        cur = self.conn.cursor()
        cur.execute(sql, tuple(params) if params else None)
        return cur

    def _executemany_raw(self, sql: str, rows: Iterable[Sequence]) -> None:
        # obs: exempt — client seam under Adapter.executemany's span+lock
        cur = self.conn.cursor()
        cur.executemany(sql, [tuple(r) for r in rows])

    def explain_sql(self, sql: str) -> str:
        """postgres spells it plain ``EXPLAIN`` (cost-annotated plan)."""
        try:
            rows = self.execute("explain " + sql)
        except Exception:
            return ""
        return "\n".join(str(r[0]) for r in rows)

    def db_bytes(self) -> int | None:
        try:
            rows = self.execute(
                "select pg_database_size(current_database())")
            return int(rows[0][0])
        except Exception:
            return None

    def insert_columns(self, name: str,
                       cols: Sequence[np.ndarray]) -> None:
        """``execute_values`` bulk path: one multi-row VALUES statement
        per ``PAGE_SIZE`` rows, page assembly inside psycopg2."""
        try:
            from psycopg2.extras import execute_values
        except ImportError:
            return Adapter.insert_columns(self, name, cols)
        cols, n = self._prepare_columns(name, cols)
        if not n:
            return
        rows = list(zip(*(c.tolist() for c in cols)))
        tr = tracer_of(self)
        with tr.span("db.ingest_values", table=name, rows=n), self.lock:
            cur = self.conn.cursor()
            execute_values(cur, f"insert into {_check_ident(name)} values %s",
                           rows, page_size=self.PAGE_SIZE)
            self.counters["statements"] += 1
