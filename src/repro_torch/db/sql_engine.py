"""The third execution backend: evaluate the expression DAG *in a database*.

``SQLEngine`` exposes the same surface as :class:`repro_torch.core.engine.Engine`
(``evaluate`` / ``eval_fn`` / ``value_and_grad_fn``) but instead of running
tensor ops it

1. pivots every leaf matrix into an ``{[i, j, v]}`` table with the
   vectorized ingestion path (:mod:`repro_torch.db.relation_io`) — unchanged
   leaves (training data across iterations) are detected by content digest
   and not re-written,
2. renders the DAG — including Algorithm-1 gradient graphs — as one WITH
   query, one CTE per node, through the persistent plan cache
   (:mod:`repro_torch.db.plan_cache`): rendering is paid once per topology ×
   dialect, across iterations AND processes, and
3. executes it on the connected engine and pivots the result tuples back
   into dense arrays (one fancy-indexed assignment per root).

It is reachable as ``Engine("sql")``; training loops route through
:mod:`repro_torch.db.train` (the recursive-CTE loop runs entirely in-database).
Because every query is executed, this backend also golden-hardens the
transpiler: any ``sqlgen`` regression turns into a failing differential
test rather than a silently wrong string.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable

import numpy as np

from ..core import autodiff
from ..core import expr as E
from ..core import sqlgen
from ..device import to_host
from ..obs import tracer_of
from . import plan_cache, relation_io
from .adapter import Adapter, connect
from .dialect import get_dialect, json_to_matrix


def _split_tagged(rows, roots: list[E.Expr]) -> list[np.ndarray]:
    """``(r, i, j, v)`` union rows → a dense matrix per root (vectorized)."""
    outs = [np.zeros(root.shape, dtype=np.float64) for root in roots]
    if not len(rows):
        return outs
    arr = np.asarray(rows, dtype=np.float64)
    r = arr[:, 0].astype(np.int64)
    i = arr[:, 1].astype(np.int64) - 1
    j = arr[:, 2].astype(np.int64) - 1
    for k, out in enumerate(outs):
        m = r == k
        out[i[m], j[m]] = arr[m, 3]
    return outs


def _digest(x, representation: str = "relational") -> bytes:
    """Content digest of a leaf matrix.  Shape, source dtype AND the
    representation are folded in next to the raw bytes: a (2,3) vs (3,2)
    reshape, an int8 vs uint8 reinterpretation, or an adapter shared
    between a relational and an array engine must never serve the
    unchanged-leaf skip across such pairs (the stored relations differ
    even when the buffer bytes agree)."""
    raw = to_host(x, dtype=None)
    a = np.ascontiguousarray(raw, dtype=np.float64)
    meta = repr((a.shape, raw.dtype.str, representation)).encode()
    return hashlib.sha256(a.tobytes() + meta).digest()


def _env_flag(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("0", "off", "false", "no", "")


class SQLEngine:
    """Evaluate expression DAGs inside sqlite (default) or duckdb."""

    kind = "sql"

    def __init__(self, backend: str = "sqlite", path: str = ":memory:",
                 adapter: Adapter | None = None, plan_cache_=None,
                 dialect=None, tracer=None, fuse: bool | None = None,
                 spool: bool | None = None, temp_leaves: bool = False):
        """``plan_cache_``: a :class:`repro_torch.db.plan_cache.PlanCache`,
        ``None`` for the shared persistent default, or ``False`` to render
        every query from scratch.

        ``dialect``: override the adapter's rendering dialect — pass
        ``"array"`` for the array-typed representation (paper §5/§7: same
        engine, one row per matrix, UDF calls per node) while the adapter
        still supplies the connection.  ``None`` keeps the adapter's
        native relational dialect.

        ``tracer``: a :class:`repro_torch.obs.Tracer` to pin to this engine (and
        its adapter).  ``None`` (default) defers to the ambient tracer
        (:func:`repro_torch.obs.use` / :func:`repro_torch.obs.install`), which is a
        zero-cost no-op unless one was installed.

        ``fuse``: run the :func:`repro_torch.core.sqlgen.fuse_dag` peephole pass
        before rendering (default on; ``REPRO_SQL_FUSE=0`` disables).
        ``spool``: materialise multi-referenced subplans as temp tables
        before the main statement — defaults to whether the dialect's
        engine flattens CTEs by substitution (sqlite < 3.35 re-executes
        every reference); ``REPRO_SQL_SPOOL`` overrides.

        ``temp_leaves``: ingest every leaf relation as a per-connection
        TEMP table.  The shard tier (``db/shard.py``) runs one engine per
        pooled connection with this on: each shard's weights and batch
        partition live in its own temp namespace, so shards never shadow
        a shared catalog, never contend for the main database's write
        lock, and never invalidate each other's matrix caches (temp
        generations key per-adapter)."""
        self.adapter = adapter if adapter is not None else connect(backend, path)
        if dialect is None:
            self.dialect = self.adapter.dialect
        else:
            self.dialect = get_dialect(dialect)
            if self.dialect is not self.adapter.dialect:
                self.dialect.prepare(self.adapter.conn)
        self.representation = self.dialect.representation
        self.fuse = _env_flag("REPRO_SQL_FUSE", True) if fuse is None \
            else bool(fuse)
        if spool is None:
            self.spool = _env_flag(
                "REPRO_SQL_SPOOL",
                getattr(self.dialect, "cte_materialization", "native")
                == "substitution")
        else:
            self.spool = bool(spool)
        self.temp_leaves = bool(temp_leaves)
        self.plans = plan_cache.resolve(plan_cache_)
        self.tracer = tracer
        if tracer is not None:
            self.adapter.tracer = tracer
        self._eval_steps = 0      # traced-evaluation counter (metric_points)
        self._steps_lock = threading.Lock()   # exact totals under the pool

    # -- representation conversion (Engine-compatible no-ops) ---------------
    def lift(self, x):
        return x

    def lower(self, x):
        return x

    # -- evaluation ---------------------------------------------------------
    def _write_env(self, roots: list[E.Expr], env: dict,
                   names=None) -> dict:
        """Materialise every free Var of the DAG as its stored relation.
        Leaves whose content digest matches what is already in the database
        are skipped — in an iteration loop only the weights move, the data
        relations are ingested once.  Changed leaves whose relation is
        already resident go through the bound-parameter delta path
        (:func:`repro_torch.db.relation_io.update_matrix_delta` /
        ``update_matrix_array``) instead of DROP+CREATE re-ingestion.
        Digests live on the adapter (``matrix_digests``) and are trusted
        only while the table's shared generation is unchanged
        (``adapter.cache_fresh``) — a sibling pooled connection's write
        flips them stale; if the sibling wrote exactly the content we
        want (shared weights, fanned out), the leaf is ADOPTED without a
        rewrite.  ``names`` restricts ingestion to a subset of the free
        Vars (the batched path writes its request leaves separately).
        Returns the ingest accounting the ``sql.ingest`` span reports."""
        stored = self.adapter.matrix_digests
        array_rep = self.representation == "array"
        info = {"leaves": 0, "skipped": 0, "delta_updates": 0,
                "bytes_written": 0, "bytes_saved": 0}
        for v in E.free_vars(*roots):
            if names is not None and v.name not in names:
                continue
            if v.name not in env:
                raise KeyError(f"env missing leaf table {v.name!r}")
            raw = env[v.name]
            info["leaves"] += 1
            d = _digest(raw, self.representation)
            a = np.ascontiguousarray(to_host(raw))
            fresh = self.adapter.cache_fresh(v.name)
            if fresh and stored.get(v.name) == d:
                info["skipped"] += 1
                info["bytes_saved"] += a.nbytes
                continue
            if not fresh:
                # drop OUR stale caches (no generation bump — the
                # resident content is a sibling's valid write) …
                self.adapter.forget(v.name)
                if self.adapter.shared_digest(v.name) == d:
                    # … and if the sibling wrote exactly this content,
                    # adopt the resident table instead of rewriting it
                    # (cache=False: its ingestion path may have round-
                    # tripped values, so no diff base is kept)
                    stored[v.name] = d
                    if a.ndim == 2:
                        relation_io._register_matrix(
                            self.adapter, v.name, a, self.representation,
                            cache=False)
                    info["skipped"] += 1
                    info["bytes_saved"] += a.nbytes
                    continue
            stored.pop(v.name, None)
            if array_rep:
                if relation_io.update_matrix_array(self.adapter, v.name, a):
                    info["delta_updates"] += 1
                else:
                    relation_io.write_matrix_array(self.adapter, v.name, a,
                                                   temp=self.temp_leaves)
                info["bytes_written"] += a.nbytes
            else:
                written = relation_io.update_matrix_delta(
                    self.adapter, v.name, a)
                if written is None:
                    relation_io.write_matrix(self.adapter, v.name, a,
                                             temp=self.temp_leaves)
                    info["bytes_written"] += a.nbytes
                else:
                    info["delta_updates"] += 1
                    info["bytes_written"] += written
                    info["bytes_saved"] += a.nbytes - written
            stored[v.name] = d
            self.adapter.record_digest(v.name, d)
        return info

    def _render(self, roots: list[E.Expr], batch=None) -> sqlgen.Plan:
        """Multi-root evaluation plan via the plan cache (or direct on
        miss): spool steps first, then the main WITH query.  ``batch``
        names the batched leaf Vars — part of the cache key, but the
        batch *size* never appears in the rendered text."""
        if self.plans is not None:
            return self.plans.dag_plan(roots, self.dialect,
                                       tail="multi_root", fuse=self.fuse,
                                       spool=self.spool,
                                       batch=batch or ())
        return sqlgen.render_plan(
            roots,
            select=sqlgen.multi_root_tail(roots, self.dialect, batch=batch),
            dialect=self.dialect, fuse=self.fuse, spool=self.spool,
            batch=batch)

    def _plan_key(self, roots: list[E.Expr]) -> str:
        """The cache key ``evaluate`` queries run under (multi-root tail).
        The fuse/spool renderer switches are part of the key — a cached
        fused plan is never served to an unfused engine or vice versa."""
        return plan_cache.plan_key(
            roots, extra=(self.dialect.name, "tail:multi_root",
                          f"fuse:{int(self.fuse)}",
                          f"spool:{int(self.spool)}"))

    def _run_plan(self, plan: sqlgen.Plan):
        """Execute a plan's spool steps (drop + create temp table — temp
        relations persist on the connection across evaluations) and then
        the main statement, returning its rows."""
        for table, sql in plan.steps:
            self.adapter.execute(f"drop table if exists {table}")
            self.adapter.execute(sql)
        return self.adapter.execute(plan.sql)

    def _ensure_explained(self, key: str, sql: str) -> None:
        """Capture the engine's EXPLAIN output for a cached plan, once.
        Must run *after* ``_write_env`` — sqlite's EXPLAIN QUERY PLAN
        resolves table names.  A failed capture records ``''`` so it is
        not retried on every call."""
        if self.plans is None or self.plans.get_explain(key) is not None:
            return
        try:
            text = self.adapter.explain_sql(sql)
        except Exception:
            text = ""
        self.plans.record_explain(key, text)

    def explain(self, roots: list[E.Expr]) -> str:
        """The engine's plan for this DAG (EXPLAIN QUERY PLAN on sqlite,
        EXPLAIN on duckdb).  Leaf tables must exist — evaluate the DAG (or
        call after a training run) first; returns ``''`` where the engine
        cannot explain the query.  Spooled plans explain the main
        statement (temp tables exist once the DAG has been evaluated)."""
        plan = self._render(roots)
        if self.plans is not None:
            key = self._plan_key(roots)
            self._ensure_explained(key, plan.sql)
            return self.plans.get_explain(key) or ""
        try:
            return self.adapter.explain_sql(plan.sql)
        except Exception:
            return ""

    def _decode(self, rows, roots: list[E.Expr]) -> list[np.ndarray]:
        """Result rows → one dense matrix per root.  Relational: tagged
        ``(r, i, j, v)`` cell tuples.  Array: one ``(r, m)`` row per root,
        ``m`` the JSON array codec."""
        if self.representation != "array":
            return _split_tagged(rows, roots)
        outs = [np.zeros(root.shape, dtype=np.float64) for root in roots]
        for r, m in rows:
            outs[int(r)] = json_to_matrix(m)
        return outs

    def _root_attrs(self, roots: list[E.Expr]) -> dict:
        """Per-IR-node attribution carried by the evaluation root span.
        Only computed when a collecting tracer is active (dag_signature
        hashes the whole DAG — never on the no-op path)."""
        return {
            "root": getattr(roots[0], "name", None) or type(roots[0]).__name__,
            "n_roots": len(roots),
            "dag_signature": sqlgen.dag_signature(roots)[:16],
            "dialect": self.dialect.name,
            "representation": self.representation,
        }

    def _record_eval_metrics(self, tr, dt_s: float, ingest: dict) -> None:
        """Per-evaluation telemetry on a collecting tracer: the latency
        histogram plus the ``metric_points`` time-series entries (plan-cache
        hit rate, bytes ingested) the regression/report layer reads."""
        with self._steps_lock:
            self._eval_steps += 1
            step = self._eval_steps
        tr.observe("sql.evaluate_ms", dt_s * 1e3)
        tr.point("sql.evaluate_ms", dt_s * 1e3, step=step,
                 dialect=self.dialect.name)
        if ingest.get("bytes_written"):
            tr.point("sql.ingest_bytes", ingest["bytes_written"], step=step)
        if self.plans is not None:
            seen = self.plans.hits + self.plans.misses
            if seen:
                tr.point("plan_cache.hit_rate", self.plans.hits / seen,
                         step=step)

    def evaluate(self, roots: list[E.Expr], env: dict) -> list[np.ndarray]:
        """One round trip: write leaves, run ONE multi-root query, read back.

        The query unions every root's tuples tagged with the root position,
        so shared CTEs (forward values reused by Algorithm 1's backward
        pass) are rendered — and executable by the engine — exactly once.
        """
        tr = tracer_of(self, self.adapter)
        if not tr.enabled:
            self._write_env(roots, env)
            rows = self._run_plan(self._render(roots))
            return self._decode(rows, roots)
        t_eval0 = time.perf_counter()
        with tr.span("sql.evaluate", **self._root_attrs(roots)) as root_sp:
            bytes0 = self.adapter.db_bytes()
            with tr.span("sql.ingest") as ing_sp:
                ingest = self._write_env(roots, env)
                ing_sp.set(**ingest)
            hits0 = self.plans.hits if self.plans is not None else 0
            with tr.span("sql.render") as sp:
                plan = self._render(roots)
                if self.plans is not None:
                    sp.set(cache="hit" if self.plans.hits > hits0 else "miss")
            for table, sql in plan.steps:      # spool before EXPLAIN — the
                self.adapter.execute(f"drop table if exists {table}")
                self.adapter.execute(sql)      # main stmt names the tables
            if self.plans is not None:
                with tr.span("sql.explain"):
                    self._ensure_explained(self._plan_key(roots), plan.sql)
            rows = self.adapter.execute(plan.sql)
            with tr.span("sql.decode"):
                outs = self._decode(rows, roots)
            bytes1 = self.adapter.db_bytes()
            root_sp.set(rows_returned=len(rows),
                        spool_steps=len(plan.steps),
                        db_bytes=(None if bytes0 is None or bytes1 is None
                                  else bytes1 - bytes0))
            self._record_eval_metrics(tr, time.perf_counter() - t_eval0,
                                      ingest)
            return outs

    def evaluate_rows(self, roots: list[E.Expr], env: dict) -> list[tuple]:
        """Like :meth:`evaluate`, but return the RAW tagged result rows —
        relational ``(r, i, j, v)`` / array ``(r, m)`` — without the dense
        decode.  The export half of cross-connection gradient shipping
        (``db/shard.py``): the coordinator re-ingests the tuples verbatim
        (``relation_io.ship_grad_rows``), so pivoting to dense here would
        be round-trip waste.  The whole round trip holds the adapter lock
        — one shard thread per connection serializes cleanly."""
        tr = tracer_of(self, self.adapter)
        with self.adapter.lock:
            if not tr.enabled:
                self._write_env(roots, env)
                return self._run_plan(self._render(roots))
            t_eval0 = time.perf_counter()
            with tr.span("sql.evaluate_rows",
                         **self._root_attrs(roots)) as root_sp:
                with tr.span("sql.ingest") as ing_sp:
                    ingest = self._write_env(roots, env)
                    ing_sp.set(**ingest)
                with tr.span("sql.render"):
                    plan = self._render(roots)
                rows = self._run_plan(plan)
                root_sp.set(rows_returned=len(rows),
                            spool_steps=len(plan.steps))
                self._record_eval_metrics(tr, time.perf_counter() - t_eval0,
                                          ingest)
                return rows

    # -- batched (multi-tenant) evaluation ----------------------------------
    def _write_batch(self, batch_env: dict) -> int:
        """Ingest the batched request leaves — ``name → (B, rows, cols)``
        stack — as per-connection TEMP tables carrying the ``b`` column.
        Returns B.  Temp tables shadow any resident relation of the same
        name for this connection only, so pooled siblings (and later
        unbatched evaluations, which re-create the main table) are
        unaffected."""
        sizes = set()
        for name, stack in batch_env.items():
            a = to_host(stack)
            if a.ndim != 3:
                raise ValueError(
                    f"batched leaf {name!r} must be a (B, rows, cols) "
                    f"stack, got shape {a.shape}")
            sizes.add(int(a.shape[0]))
            if self.representation == "array":
                relation_io.write_matrix_array_batch(self.adapter, name, a)
            else:
                relation_io.write_matrix_batch(self.adapter, name, a)
        if len(sizes) != 1:
            raise ValueError(
                f"batched leaves disagree on batch size: {sorted(sizes)}")
        return sizes.pop()

    def _decode_batched(self, rows, roots: list[E.Expr],
                        nb: int) -> list[np.ndarray]:
        """Result rows → one ``(B, rows, cols)`` stack per root.  Batched
        roots arrive with their 0-based ``b``; roots of unbatched (shared)
        subgraphs are tagged ``b = -1`` — computed once by the engine,
        broadcast across the batch here."""
        outs = [np.zeros((nb,) + root.shape, dtype=np.float64)
                for root in roots]
        if self.representation == "array":
            for r, b, m in rows:
                mat = json_to_matrix(m)
                if int(b) < 0:
                    outs[int(r)][:] = mat
                else:
                    outs[int(r)][int(b)] = mat
            return outs
        if not len(rows):
            return outs
        arr = np.asarray(rows, dtype=np.float64)
        r = arr[:, 0].astype(np.int64)
        b = arr[:, 1].astype(np.int64)
        i = arr[:, 2].astype(np.int64) - 1
        j = arr[:, 3].astype(np.int64) - 1
        for k, out in enumerate(outs):
            m = (r == k) & (b >= 0)
            out[b[m], i[m], j[m]] = arr[m, 4]
            mb = (r == k) & (b < 0)
            if mb.any():
                base = np.zeros(roots[k].shape, dtype=np.float64)
                base[i[mb], j[mb]] = arr[mb, 4]
                out[:] = base
        return outs

    def evaluate_batched(self, roots: list[E.Expr], env: dict,
                         batch_env: dict) -> list[np.ndarray]:
        """ONE query, B independent requests (the multi-tenant tier).

        ``batch_env`` maps request-leaf names to ``(B, rows, cols)``
        stacks; ``env`` supplies the shared leaves (weights) exactly as in
        :meth:`evaluate` — they are ingested once and joined without a
        ``b`` predicate, so every request reads the same resident
        relations.  Returns one ``(B, rows, cols)`` stack per root,
        request ``k`` of the output identical (≤ float64 noise) to
        ``evaluate`` on request ``k`` alone.  The rendered plan carries no
        literal B — one cached entry serves every batch size, including
        B=1 and a ragged final micro-batch.  The whole round trip holds
        the adapter lock: concurrent callers serialize per connection
        (use a :class:`repro_torch.db.adapter.ConnectionPool` to overlap)."""
        if not batch_env:
            raise ValueError("batch_env must name at least one batched leaf")
        batch = tuple(sorted(batch_env))
        free = {v.name for v in E.free_vars(*roots)}
        unknown = set(batch) - free
        if unknown:
            raise KeyError(f"batched leaves not free in the DAG: "
                           f"{sorted(unknown)}")
        shared = free - set(batch)
        tr = tracer_of(self, self.adapter)
        with self.adapter.lock:
            if not tr.enabled:
                self._write_env(roots, env, names=shared)
                nb = self._write_batch(batch_env)
                rows = self._run_plan(self._render(roots, batch=batch))
                return self._decode_batched(rows, roots, nb)
            t_eval0 = time.perf_counter()
            with tr.span("sql.evaluate_batched",
                         **self._root_attrs(roots)) as root_sp:
                with tr.span("sql.ingest") as ing_sp:
                    ingest = self._write_env(roots, env, names=shared)
                    nb = self._write_batch(batch_env)
                    ing_sp.set(batch=nb, **ingest)
                with tr.span("sql.render"):
                    plan = self._render(roots, batch=batch)
                rows = self._run_plan(plan)
                with tr.span("sql.decode"):
                    outs = self._decode_batched(rows, roots, nb)
                root_sp.set(rows_returned=len(rows), batch=nb,
                            spool_steps=len(plan.steps))
                self._record_eval_metrics(
                    tr, time.perf_counter() - t_eval0, ingest)
                return outs

    def eval_fn(self, roots: list[E.Expr]) -> Callable:
        """Evaluator with the Engine.eval_fn contract (no jit — the
        "compilation" is the SQL rendering, done once here and reused from
        the plan cache across topologically identical graphs)."""
        plan = self._render(roots)
        explained = [self.plans is None]  # explain once, after tables exist

        def fn(env: dict) -> list[np.ndarray]:
            tr = tracer_of(self, self.adapter)
            if not tr.enabled:
                self._write_env(roots, env)
                return self._decode(self._run_plan(plan), roots)
            t_eval0 = time.perf_counter()
            with tr.span("sql.evaluate", **self._root_attrs(roots)) as root_sp:
                with tr.span("sql.ingest") as ing_sp:
                    ingest = self._write_env(roots, env)
                    ing_sp.set(**ingest)
                for table, sql in plan.steps:
                    self.adapter.execute(f"drop table if exists {table}")
                    self.adapter.execute(sql)
                if not explained[0]:
                    with tr.span("sql.explain"):
                        self._ensure_explained(self._plan_key(roots),
                                               plan.sql)
                    explained[0] = True
                rows = self.adapter.execute(plan.sql)
                with tr.span("sql.decode"):
                    outs = self._decode(rows, roots)
                root_sp.set(rows_returned=len(rows),
                            spool_steps=len(plan.steps))
                self._record_eval_metrics(tr, time.perf_counter() - t_eval0,
                                          ingest)
                return outs

        return fn

    def value_and_grad_fn(self, loss: E.Expr, wrt: list[E.Var]) -> Callable:
        """env → (loss value, {var name: gradient}), gradients from
        Algorithm 1 rendered as CTEs and executed in-database."""
        grads = autodiff.gradients(loss, wrt)
        roots = [loss] + [grads[v] for v in wrt]
        fn = self.eval_fn(roots)

        steps = [0]

        def vg(env: dict):
            outs = fn(env)
            tr = tracer_of(self, self.adapter)
            if tr.enabled:        # the training curve, straight off the DAG
                steps[0] += 1
                tr.point("train.loss", float(np.mean(outs[0])),
                         step=steps[0])
                gn = float(np.sqrt(sum(float(np.sum(g * g))
                                       for g in outs[1:])))
                tr.point("train.grad_norm", gn, step=steps[0])
            return outs[0], {v.name: g for v, g in zip(wrt, outs[1:])}

        return vg

    # -- profiled execution mode --------------------------------------------
    def profile(self, roots: list[E.Expr], env: dict):
        """Profiled evaluation: same outputs as :meth:`evaluate`, plus a
        per-IR-node cost table (:class:`repro_torch.obs.profiler.ProfileResult`)
        — every non-leaf node runs as its own timed temp-table step."""
        from ..obs import profiler
        return profiler.profile_evaluate(self, roots, env)

    def profile_value_and_grad(self, loss: E.Expr, wrt: list[E.Var],
                               env: dict):
        """Profile the loss + Algorithm-1 gradient DAG — the exact
        multi-root query one ``train.in_db`` iteration executes."""
        from ..obs import profiler
        return profiler.profile_value_and_grad(self, loss, wrt, env)

    # -- introspection ------------------------------------------------------
    @property
    def stats(self) -> dict:
        """One merged counter view over the whole engine: plan-cache
        hit/miss/eviction counters (the LRU no longer evicts silently),
        adapter query/ingestion counters, and — when a collecting tracer is
        pinned — its counters/gauges.  Flat convenience keys up front for
        the common questions; the nested dicts carry everything."""
        cache = self.plans.stats if self.plans is not None else {}
        adapter = dict(self.adapter.counters)
        out = {
            "cache_hits": cache.get("hits", 0),
            "cache_misses": cache.get("misses", 0),
            "cache_evictions": (cache.get("evictions", 0)
                                + cache.get("evictions_disk", 0)),
            "queries": adapter.get("queries", 0),
            "ingest_bytes": adapter.get("ingest_bytes", 0),
            "plan_cache": cache,
            "adapter": adapter,
        }
        db_bytes = self.adapter.db_bytes()
        if db_bytes is not None:
            out["db_bytes"] = db_bytes
        tr = self.tracer
        if tr is not None and tr.enabled:
            out["tracer"] = {"spans": len(tr.spans),
                             "counters": tr.counters, "gauges": tr.gauges}
        return out

    @staticmethod
    def merged_stats(engines: "list[SQLEngine]") -> dict:
        """Shard-aware stats: sum the integer counters of N per-shard
        engines (plan-cache counters are shared, so they are taken from
        the first engine rather than multiply counted).  What
        ``train_in_db(shards=N)`` reports as its engine view."""
        if not engines:
            return {}
        first = engines[0].stats
        shared_cache = {e.plans for e in engines if e.plans is not None}
        out = {"shards": len(engines),
               "plan_cache": first.get("plan_cache", {}),
               "cache_hits": first.get("cache_hits", 0),
               "cache_misses": first.get("cache_misses", 0)}
        adapter_total: dict = {}
        for e in engines:
            for k, v in e.adapter.counters.items():
                adapter_total[k] = adapter_total.get(k, 0) + v
        out["adapter"] = adapter_total
        out["queries"] = adapter_total.get("queries", 0)
        out["ingest_bytes"] = adapter_total.get("ingest_bytes", 0)
        if len(shared_cache) > 1:  # distinct caches — sum them honestly
            out["cache_hits"] = sum(e.plans.hits for e in engines
                                    if e.plans is not None)
            out["cache_misses"] = sum(e.plans.misses for e in engines
                                      if e.plans is not None)
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self.adapter.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
