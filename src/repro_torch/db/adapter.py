"""The adapter tier's short import path, as in ``repro.db.adapter``: the
contract (``adapters/base.py``) and the per-backend modules (``sqlite`` /
``duckdb`` / ``postgres``) live in :mod:`repro_torch.db.adapters`."""
from __future__ import annotations

from .adapters import (CHUNK_ROWS, SLOW_QUERY_ENV, SQL_HEAD, Adapter,
                       ConnectionPool, DuckDBAdapter, HAVE_PSYCOPG2,
                       PG_DSN_ENV, PostgresAdapter, SQLiteAdapter,
                       _check_ident, connect, log)
from .adapters.base import (_CONN_SEQ, _GEN_LOCK, _IDENT, _TABLE_DIGEST,
                            _TABLE_GEN, _slow_threshold_s)

__all__ = [
    "Adapter", "SQLiteAdapter", "DuckDBAdapter", "PostgresAdapter",
    "HAVE_PSYCOPG2", "PG_DSN_ENV", "connect", "ConnectionPool",
    "CHUNK_ROWS", "SLOW_QUERY_ENV", "SQL_HEAD", "log",
]
