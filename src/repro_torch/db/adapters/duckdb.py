"""The duckdb backend — only when the ``duckdb`` package is importable.

Ingestion rides duckdb's native bulk path: zero-loop registration of the
column arrays (Arrow table when ``pyarrow`` is importable, pandas/numpy
dict otherwise) followed by one ``INSERT INTO … SELECT``."""
from __future__ import annotations

import os

from ...obs import tracer_of
from ..dialect import HAVE_DUCKDB, DuckDBDialect, duckdb
from .base import Adapter


class DuckDBAdapter(Adapter):
    placeholder = "?"

    def __init__(self, path: str = ":memory:"):
        if not HAVE_DUCKDB:  # pragma: no cover - depends on environment
            raise ImportError("duckdb is not installed; "
                              "use backend='sqlite' or pip install repro[db]")
        self.dialect = DuckDBDialect()
        super().__init__(duckdb.connect(path))
        if path != ":memory:":  # pragma: no cover - needs duckdb
            self._db_key = "duckdb:" + os.path.abspath(path)

    def cursor_adapter(self) -> "DuckDBAdapter":  # pragma: no cover - duckdb
        """A pool worker over this connection: ``conn.cursor()`` is a full
        DuckDBPyConnection sharing the root's catalog, with its own temp
        namespace and transaction state — duckdb's one-writer model with
        per-worker cursors.  The worker shares ``_db_key`` (same logical
        database) but carries its own lock and caches.
        """
        # obs: exempt — pool-worker construction, not a query; every
        # statement the worker runs goes through the traced base methods
        other = object.__new__(DuckDBAdapter)
        other.dialect = DuckDBDialect()
        Adapter.__init__(other, self.conn.cursor())
        other._db_key = self._db_key
        return other

    def executemany(self, sql, rows):  # pragma: no cover - needs duckdb
        # tuple-normalise for duckdb's binder, then ride the traced base
        Adapter.executemany(self, sql, [tuple(r) for r in rows])

    def explain_sql(self, sql: str) -> str:  # pragma: no cover - needs duckdb
        """duckdb spells it plain ``EXPLAIN`` (physical plan as text)."""
        try:
            rows = self.execute("explain " + sql)
        except Exception:
            return ""
        return "\n".join(str(r[-1]) for r in rows)

    def insert_columns(self, name, cols):  # pragma: no cover - needs duckdb
        """Register the column arrays as a relation (Arrow when available,
        else a pandas DataFrame built zero-copy from the ndarrays) and run
        ONE ``INSERT INTO … SELECT`` — duckdb's native bulk path; no
        per-row Python at all."""
        cols, n = self._prepare_columns(name, cols)
        if not n:
            return
        names = [f"c{k}" for k in range(len(cols))]
        view = f"_ingest_{name}"
        frame = None
        try:
            import pyarrow as pa
            frame = pa.table({nm: pa.array(c) for nm, c in zip(names, cols)})
        except ImportError:
            try:
                import pandas as pd
                frame = pd.DataFrame(dict(zip(names, cols)))
            except ImportError:
                pass
        if frame is None:  # no columnar frontend — generic chunked path
            Adapter.insert_columns(self, name, cols)
            return
        tr = tracer_of(self)
        with tr.span("db.ingest_register", table=name, rows=n):
            self.conn.register(view, frame)
            try:
                self.execute(f"insert into {name} select * from {view}")
            finally:
                self.conn.unregister(view)
