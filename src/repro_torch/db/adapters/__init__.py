"""Connection adapters over the engines Python can reach.

One :class:`~repro_torch.db.adapters.base.Adapter` contract, three backends:

``SQLiteAdapter``   — stdlib ``sqlite3``; always available, the default.
``DuckDBAdapter``   — only when the ``duckdb`` package is importable.
``PostgresAdapter`` — only when ``psycopg2`` is importable AND a server
                      DSN is supplied (argument or ``REPRO_PG_DSN``).

``connect`` picks a backend by name; :class:`ConnectionPool` fans one
logical database out to N worker adapters (the substrate under both the
batch server and the data-parallel shard trainer, ``db/shard.py``)."""
from __future__ import annotations

from .base import (CHUNK_ROWS, SLOW_QUERY_ENV, SQL_HEAD, Adapter,
                   _check_ident, log)
from .duckdb import DuckDBAdapter
from .postgres import HAVE_PSYCOPG2, PG_DSN_ENV, PostgresAdapter
from .sqlite import SQLiteAdapter
from ..dialect import HAVE_DUCKDB

__all__ = [
    "Adapter", "SQLiteAdapter", "DuckDBAdapter", "PostgresAdapter",
    "HAVE_PSYCOPG2", "PG_DSN_ENV", "connect", "ConnectionPool",
    "CHUNK_ROWS", "SLOW_QUERY_ENV", "SQL_HEAD", "log",
]


def connect(backend: str = "sqlite", path: str = ":memory:") -> Adapter:
    """Open the requested backend; ``'auto'`` prefers duckdb when present.
    For postgres, ``path`` is the libpq DSN (``REPRO_PG_DSN`` when empty
    or left at the ``":memory:"`` default)."""
    if backend == "auto":
        backend = "duckdb" if HAVE_DUCKDB else "sqlite"
    if backend == "sqlite":
        return SQLiteAdapter(path)
    if backend == "duckdb":
        return DuckDBAdapter(path)
    if backend == "postgres":
        return PostgresAdapter(path)
    raise ValueError(f"unknown backend {backend!r}; "
                     "expected 'sqlite', 'duckdb', 'postgres' or 'auto'")


class ConnectionPool:
    """A fixed set of worker adapters over ONE logical database — the
    connection tier under :class:`repro_torch.serving.db_serve.SQLBatchServer`
    and the shard axis of :func:`repro_torch.db.shard.train_in_db_sharded`.

    * **sqlite file** — one WAL-mode connection per worker: WAL gives many
      concurrent readers plus one writer, ``busy_timeout`` absorbs writer
      collisions, and the shared generation registry keeps the per-
      connection matrix caches coherent (same ``_db_key``).
    * **sqlite** ``:memory:`` — N *independent* databases (stdlib sqlite3
      shares an in-memory DB only through the deprecated ``cache=shared``
      URI); shared leaves must be ingested into every worker — the batch
      server's ``start()`` and the shard trainer's temp-leaf ingestion do.
    * **duckdb** — ONE root connection, ``.cursor()`` per extra worker:
      each cursor is a full connection over the root's catalog with its
      own temp-table namespace.
    * **postgres** — one session per worker on the same DSN: a shared
      server-side catalog (same ``_db_key``) with per-session temp
      namespaces.
    """

    def __init__(self, backend: str = "sqlite", path: str = ":memory:",
                 size: int = 4):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        self.backend = backend
        self.path = path
        root = connect(backend, path)
        workers = [root]
        for _ in range(size - 1):
            if isinstance(root, DuckDBAdapter):  # pragma: no cover - duckdb
                workers.append(root.cursor_adapter())
            else:
                workers.append(connect(backend, path))
        self.adapters: list[Adapter] = workers

    def __len__(self) -> int:
        return len(self.adapters)

    def __iter__(self):
        return iter(self.adapters)

    def __getitem__(self, i: int) -> Adapter:
        return self.adapters[i]

    def close(self) -> None:
        # workers first, root (duckdb cursor parent) last
        for a in self.adapters[:0:-1]:
            try:
                a.close()
            except Exception:  # pragma: no cover - already-closed cursors
                pass
        self.adapters[0].close()
