"""In-database execution backend (the paper's actual thesis, closed-loop;
PyTorch port of ``repro.db``).

``repro_torch.db`` runs the generated SQL in a real engine instead of printing it:

* :mod:`~repro_torch.db.dialect` — SQL dialects (sql92 golden, sqlite, duckdb)
  plus the UDF array extension (the §5 analogue for stock engines);
* :mod:`~repro_torch.db.adapters` — one ``Adapter`` contract over ``sqlite3`` /
  ``duckdb`` / ``psycopg2`` (``adapter`` is the back-compat shim);
* :mod:`~repro_torch.db.relation_io` — dense arrays ↔ ``{[i, j, v]}`` tables
  (vectorized pivots);
* :mod:`~repro_torch.db.plan_cache` — persistent cache of rendered SQL plans;
* :mod:`~repro_torch.db.sql_engine` — ``SQLEngine``, the ``Engine("sql")`` backend;
* :mod:`~repro_torch.db.train` — Listing 7/10 training + Listing 8 inference
  executed inside the database.

* :mod:`~repro_torch.db.shard` — data-parallel training across a
  connection pool with a SQL AllReduce (``train_in_db(shards=N)``);
* :mod:`~repro_torch.db.zoo` — the DAG zoo in SQL: MoE dispatch/combine,
  the RWKV recurrences and the SSD/LRU scans transpiled to executable
  queries (§8 outlook).

Submodules that depend on :mod:`repro_torch.core` are loaded lazily so that
``core`` ↔ ``db`` imports cannot cycle.
"""
from . import adapter, adapters, dialect, relation_io
from .adapter import (Adapter, ConnectionPool, DuckDBAdapter,
                      PostgresAdapter, SQLiteAdapter, connect)
from .dialect import (ARRAY_UDFS, HAVE_DUCKDB, ArrayDialect, DuckDBDialect,
                      PostgresDialect, Sql92Dialect, SqliteDialect,
                      get_dialect, json_to_matrix, matrix_to_json)

__all__ = [
    "adapter", "adapters", "dialect", "relation_io", "plan_cache",
    "sql_engine", "train", "shard", "zoo",
    "Adapter", "SQLiteAdapter", "DuckDBAdapter", "PostgresAdapter",
    "ConnectionPool", "connect",
    "Sql92Dialect", "SqliteDialect", "DuckDBDialect", "PostgresDialect",
    "ArrayDialect", "get_dialect",
    "ARRAY_UDFS", "HAVE_DUCKDB", "matrix_to_json", "json_to_matrix",
    "SQLEngine", "PlanCache", "train_in_db", "infer_in_db", "predict_in_db",
    "train_in_db_sharded",
]

_LAZY = {
    "plan_cache": ("repro_torch.db.plan_cache", None),
    "sql_engine": ("repro_torch.db.sql_engine", None),
    "train": ("repro_torch.db.train", None),
    "shard": ("repro_torch.db.shard", None),
    "zoo": ("repro_torch.db.zoo", None),
    "SQLEngine": ("repro_torch.db.sql_engine", "SQLEngine"),
    "PlanCache": ("repro_torch.db.plan_cache", "PlanCache"),
    "train_in_db": ("repro_torch.db.train", "train_in_db"),
    "infer_in_db": ("repro_torch.db.train", "infer_in_db"),
    "predict_in_db": ("repro_torch.db.train", "predict_in_db"),
    "train_in_db_sharded": ("repro_torch.db.shard", "train_in_db_sharded"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    mod = importlib.import_module(mod_name)
    return getattr(mod, attr) if attr else mod
