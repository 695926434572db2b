"""Persistent cache of rendered SQL plans.

Rendering the expression DAG to SQL (``core.sqlgen``) is pure string work,
but a training loop pays it on every ``train_in_db`` call and every process
start — while the *topology* of the query never changes between iterations
(the ROADMAP's "persistent ``repro_torch.db`` cache of rendered SQL").  This
module stores rendered statements keyed by

    ``dag_signature(roots) × dialect × select-tail kind``

(:func:`repro_torch.core.sqlgen.dag_signature` — structural, explicit names only),
in a two-level store: a process-local dict in front of a sqlite file that
survives sessions.  Because ``sqlgen`` renders auto-named nodes
deterministically by topo position, a plan rendered by one process is
byte-valid in any other — leaf (Var) table names are part of the signature.

Environment:

``REPRO_PLAN_CACHE``
    Path of the persistent store.  Default
    ``~/.cache/repro_torch/plan_cache.db``; set to ``off`` (or ``0``) to keep the
    cache memory-only.

``REPRO_PLAN_CACHE_CAP``
    LRU capacity (entries) of both layers; default 512.  Every distinct
    (DAG × dialect × tail) topology is one entry — rendered SQL for deep
    scan graphs runs to tens of KB, so an uncapped store grows without
    bound under topology-churning workloads (per-(T, D) MatRecurrence
    plans, state-size sweeps).  Eviction is least-recently-*used*: the
    in-process dict keeps exact recency, the persistent table is pruned
    on insert by its ``last_used`` column (touched on every hit).
"""
from __future__ import annotations

import collections
import hashlib
import inspect
import os
import sqlite3
import threading
import time

from ..core import expr as E
from ..core import sqlgen

_ENV = "REPRO_PLAN_CACHE"
_CAP_ENV = "REPRO_PLAN_CACHE_CAP"
_DISABLED = {"off", "0", "none", "disabled"}

#: default LRU capacity (entries) of the in-process AND persistent layers
DEFAULT_CAP = 512

_FINGERPRINT: str | None = None


def renderer_fingerprint() -> str:
    """Content hash of the rendering code — part of every plan key, so a
    cached plan can never outlive the code that produced it (a persistent
    store otherwise serves stale SQL after transpiler fixes).  Rendered
    text depends on ``core.sqlgen`` (structure), ``core.autodiff`` (the
    gradient DAGs baked into training queries keyed on the loss DAG alone)
    and ``db.dialect`` (map/const/series spellings) — all three sources
    are hashed."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        from ..core import autodiff
        from . import dialect as dialect_mod
        chunks = []
        for mod in (sqlgen, autodiff, dialect_mod):
            try:
                chunks.append(inspect.getsource(mod))
            except (OSError, TypeError):  # pragma: no cover - frozen installs
                chunks.append(getattr(mod, "__file__", "") or "unknown")
        _FINGERPRINT = hashlib.sha256("\0".join(chunks).encode()) \
            .hexdigest()[:16]
    return _FINGERPRINT


def plan_key(roots: list[E.Expr], extra=()) -> str:
    """The cache key: structural DAG signature × renderer fingerprint ×
    caller extras (dialect, tail/renderer kind, hyper-parameters)."""
    return sqlgen.dag_signature(roots,
                                extra=(renderer_fingerprint(),) + tuple(extra))


def default_path() -> str | None:
    """Resolve the persistent-store path (None → memory-only)."""
    p = os.environ.get(_ENV)
    if p is not None:
        return None if p.strip().lower() in _DISABLED else p
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "plan_cache.db")


class PlanCache:
    """Two-level plan store: in-process dict over an optional sqlite file.

    The sqlite layer is best-effort — any failure to open or write it
    (read-only home, concurrent lock) silently degrades to memory-only, so
    the execution backend never breaks on cache trouble.

    Both layers are LRU-capped at ``cap`` entries (default
    :data:`DEFAULT_CAP`, overridable via ``REPRO_PLAN_CACHE_CAP``): the
    in-process dict evicts its least-recently-used key on insert, and
    every insert prunes the persistent ``plans`` table down to the cap by
    ``last_used``.  Hits record recency in memory only; the pending
    touches are flushed to disk right before each pruning pass (and on
    close), so the hot working set survives topology churn while the
    get() hot path never writes.
    """

    def __init__(self, path: str | None = "default", cap: int | None = None):
        if path == "default":
            path = default_path()
        if cap is None:
            try:  # cache trouble never breaks the backend — bad env too
                cap = int(os.environ.get(_CAP_ENV, DEFAULT_CAP))
            except ValueError:
                cap = DEFAULT_CAP
        self.cap = max(1, int(cap))
        self.path = path
        #: serializes BOTH layers: the OrderedDict's move_to_end/popitem
        #: and the persistent store's touch-flush → insert → prune
        #: sequence are read-modify-write — racing pool workers could
        #: evict a just-loaded hot plan or double-insert.  Re-entrant so
        #: ``rendered`` may call ``get``/``put`` while holding it.
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        #: entries dropped by the in-process LRU / the persistent prune —
        #: eviction is no longer silent (surfaced via ``stats`` and merged
        #: into ``SQLEngine.stats``)
        self.evictions = 0
        self.evictions_disk = 0
        self._mem: collections.OrderedDict[str, str] = collections.OrderedDict()
        self._touched: set[str] = set()   # hit recency pending disk flush
        #: key → captured engine plan text (EXPLAIN QUERY PLAN / EXPLAIN),
        #: stored alongside the rendered SQL; '' means capture unsupported
        self._explains: dict[str, str] = {}
        self._conn = None
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                # the store is accessed from whichever pool worker hits
                # it; all access is serialized on self._lock
                self._conn = sqlite3.connect(path, check_same_thread=False)
                self._conn.execute(
                    "create table if not exists plans ("
                    " key text primary key, dialect text, sql text,"
                    " created real, last_used real, explain_text text)")
                cols = [r[1] for r in self._conn.execute(
                    "pragma table_info(plans)")]
                if "last_used" not in cols:  # pre-LRU store: migrate in place
                    self._conn.execute("alter table plans"
                                       " add column last_used real")
                    self._conn.execute("update plans set last_used = created")
                if "explain_text" not in cols:  # pre-obs store: migrate
                    self._conn.execute("alter table plans"
                                       " add column explain_text text")
                self._conn.commit()
            except Exception:  # pragma: no cover - env-dependent degradation
                self._conn = None

    # -- store --------------------------------------------------------------
    def _mem_insert(self, key: str, sql: str) -> None:
        self._mem[key] = sql
        self._mem.move_to_end(key)
        while len(self._mem) > self.cap:
            dropped, _ = self._mem.popitem(last=False)
            self._explains.pop(dropped, None)
            self.evictions += 1

    def _flush_touched(self) -> None:
        """Write the recency of keys touched since the last flush.  Hits
        stay pure in-memory operations (the cache's whole point is a
        cheap hot path — one UPDATE + fsync per get() would cost more
        than the render it saves); the persistent ``last_used`` only
        needs to be current when it is *read*, i.e. right before a
        put()'s pruning pass and at close()."""
        if self._conn is None or not self._touched:
            return
        now = time.time()
        self._conn.executemany(
            "update plans set last_used = ? where key = ?",
            [(now, k) for k in self._touched])
        self._touched.clear()

    def get(self, key: str) -> str | None:
        with self._lock:
            sql = self._mem.get(key)
            if sql is None and self._conn is not None:
                try:
                    row = self._conn.execute(
                        "select sql from plans where key = ?",
                        (key,)).fetchone()
                except Exception:  # pragma: no cover
                    row = None
                if row:
                    sql = row[0]
                    self._mem_insert(key, sql)
            if sql is None:
                self.misses += 1
            else:
                self.hits += 1
                if key in self._mem:
                    self._mem.move_to_end(key)
                if self._conn is not None:  # pending flush; else unbounded
                    self._touched.add(key)
            return sql

    def put(self, key: str, sql: str, dialect: str = "") -> None:
        with self._lock:
            self._mem_insert(key, sql)
            if self._conn is None:
                return
            try:
                self._flush_touched()   # recency must be current for prune
                # stamp AFTER the flush: the new plan must not look colder
                # than the just-flushed hits, or an at-cap prune would
                # evict the plan being inserted
                now = time.time()
                self._conn.execute(
                    "insert or replace into plans"
                    " (key, dialect, sql, created, last_used, explain_text)"
                    " values (?, ?, ?, ?, ?, ?)",
                    (key, dialect, sql, now, now, self._explains.get(key)))
                n = self._conn.execute(
                    "select count(*) from plans").fetchone()[0]
                if n > self.cap:  # prune the coldest down to the cap
                    self._conn.execute(
                        "delete from plans where key in (select key from"
                        " plans order by last_used asc, created asc"
                        " limit ?)", (n - self.cap,))
                    self.evictions_disk += n - self.cap
                self._conn.commit()
            except Exception:  # pragma: no cover
                pass

    # -- engine plan introspection -------------------------------------------
    def record_explain(self, key: str, text: str) -> None:
        """Attach the engine's EXPLAIN output to a cached plan (captured
        once per plan by the SQLEngine; '' marks capture as unsupported so
        it is not retried).  Persisted next to the rendered SQL."""
        with self._lock:
            self._explains[key] = text
            if self._conn is None:
                return
            try:
                self._conn.execute(
                    "update plans set explain_text = ? where key = ?",
                    (text, key))
                self._conn.commit()
            except Exception:  # pragma: no cover
                pass

    def get_explain(self, key: str) -> str | None:
        """EXPLAIN text for a cached plan (None: never captured)."""
        with self._lock:
            text = self._explains.get(key)
            if text is None and self._conn is not None:
                try:
                    row = self._conn.execute(
                        "select explain_text from plans where key = ?",
                        (key,)).fetchone()
                except Exception:  # pragma: no cover
                    row = None
                if row and row[0] is not None:
                    text = row[0]
                    self._explains[key] = text
            return text

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._touched.clear()
            self._explains.clear()
            if self._conn is None:
                return
            try:
                self._conn.execute("delete from plans")
                self._conn.commit()
            except Exception:  # pragma: no cover
                pass

    def __len__(self) -> int:
        with self._lock:
            if self._conn is not None:
                try:
                    return self._conn.execute(
                        "select count(*) from plans").fetchone()[0]
                except Exception:  # pragma: no cover
                    pass
            return len(self._mem)

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "evictions_disk": self.evictions_disk,
                "explains": len(self._explains),
                "entries": len(self), "cap": self.cap, "path": self.path}

    def close(self) -> None:
        with self._lock:
            if self._conn is None:
                return
            try:
                self._flush_touched()
                self._conn.commit()
            except Exception:  # pragma: no cover
                pass
            try:
                self._conn.close()
            except Exception:  # pragma: no cover
                pass
            self._conn = None

    # -- rendering through the cache ----------------------------------------
    def rendered(self, key: str, dialect_name: str, render) -> str:
        """``render()`` is called only on a miss; its output is stored.
        Held under the lock end-to-end so concurrent misses on one key
        render once — the second worker hits the first one's insert."""
        with self._lock:
            sql = self.get(key)
            if sql is None:
                sql = render()
                self.put(key, sql, dialect_name)
            return sql

    def dag_sql(self, roots: list[E.Expr], dialect, tail: str = "last") -> str:
        """Rendered WITH query for ``roots``; ``tail`` ∈ {'last',
        'multi_root'} selects the statement tail kind (part of the key).
        The dialect name keys the entry, so the same DAG under different
        representations (``sqlite`` cell-relational vs ``array``) can
        never share — or cross-serve — a cached plan."""
        if tail not in ("last", "multi_root"):
            raise ValueError(f"unknown tail kind {tail!r}")
        key = plan_key(roots, extra=(dialect.name, f"tail:{tail}"))
        select = (sqlgen.multi_root_tail(roots, dialect)
                  if tail == "multi_root" else None)
        return self.rendered(
            key, dialect.name,
            lambda: sqlgen.to_sql(roots, select=select, dialect=dialect))

    def dag_plan(self, roots: list[E.Expr], dialect, tail: str = "last",
                 fuse: bool = False, spool: bool = False,
                 batch=()) -> sqlgen.Plan:
        """Rendered evaluation :class:`repro_torch.core.sqlgen.Plan` (spool
        steps + main statement) for ``roots``.  ``fuse`` and ``spool`` are
        folded into the key alongside dialect and tail, so a fused plan is
        never served to an unfused renderer (and vice versa) — the stored
        value is the plan's text serialisation, shared across processes
        like any other entry.  ``batch`` names the batched leaf Vars
        (multi-tenant serving): the WHICH-leaves-carry-``b`` set keys the
        entry, but the batch *size* does not appear in the rendered text —
        one cached plan serves any B."""
        if tail not in ("last", "multi_root"):
            raise ValueError(f"unknown tail kind {tail!r}")
        batch = tuple(sorted(batch)) if batch else ()
        extra = [dialect.name, f"tail:{tail}", f"fuse:{int(fuse)}",
                 f"spool:{int(spool)}"]
        if batch:
            extra.append("batch:" + ",".join(batch))
        key = plan_key(roots, extra=tuple(extra))
        select = (sqlgen.multi_root_tail(roots, dialect, batch=batch or None)
                  if tail == "multi_root" else None)
        text = self.rendered(
            key, dialect.name,
            lambda: sqlgen.render_plan(roots, select=select, dialect=dialect,
                                       fuse=fuse, spool=spool,
                                       batch=batch or None).to_text())
        return sqlgen.Plan.from_text(text)


_default: PlanCache | None = None


def default_cache() -> PlanCache:
    """The process-wide shared cache (persistent unless disabled via env)."""
    global _default
    if _default is None:
        _default = PlanCache()
    return _default


def resolve(cache) -> PlanCache | None:
    """Normalise a user-supplied cache argument: None → shared default,
    False → caching off, or a :class:`PlanCache` instance."""
    if cache is None:
        return default_cache()
    if cache is False:
        return None
    return cache
