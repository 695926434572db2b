"""Run the paper's training and inference loops *inside* the database.

Three fully-in-database execution strategies for the Listing 7/10 training
recursion, picked per engine capability:

``strategy="recursive"`` (default)
    ONE recursive-CTE query performs every iteration.

    * sqlite — the Listing-10 *array* variant
      (:func:`repro_torch.core.sqlgen.training_query_array_calls`): weight state
      rides in one row of array-typed (JSON) columns, matrix algebra comes
      from the registered UDF array extension.  This is the shape sqlite's
      recursive-select restrictions admit.
    * duckdb — Listing 7 verbatim
      (:func:`repro_torch.core.sqlgen.training_query_sql92`): the relational
      ``w(iter, id, i, j, v)`` recursion with pure SQL-92 math.

``strategy="stepped"``
    Listing 7's recursive *step* materialised as ``INSERT INTO w … SELECT``
    (:func:`repro_torch.core.sqlgen.training_step_sql92`), executed once per
    iteration — all matrix math still pure SQL-92 inside the engine; only
    the iteration loop (``recursive_cte_py``) lives outside, exactly the
    role the recursive CTE plays in Listing 7.  Works on every backend.

Inference (Listing 8/11) runs the forward CTEs in-database, including the
``highestposition`` rank-1 comparison as a window function.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import expr as E
from ..core import sqlgen
from ..core.recursive_cte import recursive_cte_py
from ..device import to_host
from ..obs import tracer_of
from . import plan_cache, relation_io
from .adapter import Adapter, connect
from .dialect import json_to_matrix, matrix_to_json
from .sql_engine import SQLEngine


def _training_sql(graph, kind: str, adapter: Adapter, render, cache,
                  *key_extra) -> str:
    """Render one of the training statements through the plan cache:
    keyed by the loss DAG's structural signature × renderer fingerprint ×
    dialect × renderer kind × hyper-parameters, so re-running a benchmark
    (or the next training session) skips ``sqlgen`` entirely.  ``cache``
    follows the :func:`repro_torch.db.plan_cache.resolve` convention (None →
    shared default, False → render fresh)."""
    dialect_name = adapter.dialect.name
    cache = plan_cache.resolve(cache)
    tr = tracer_of(adapter)
    with tr.span("sql.render", kind=f"train:{kind}") as sp:
        if cache is None:
            return render()
        key = plan_cache.plan_key(
            [graph.loss], extra=(dialect_name, f"train:{kind}") + key_extra)
        hits0 = cache.hits
        sql = cache.rendered(key, dialect_name, render)
        if tr.enabled:
            sp.set(cache="hit" if cache.hits > hits0 else "miss")
        return sql


@dataclasses.dataclass
class DBTrainResult:
    """Outcome of an in-database training run."""

    weights: dict[str, np.ndarray]        # final iterate
    history: list[dict[str, np.ndarray]]  # every iterate, incl. iter 0
    strategy: str
    sql: str                              # the (last) query that ran
    #: bytes the training recursion materialised (every iterate stays in
    #: the recursive weight relation — the paper's Fig. 5 memory axis)
    cte_bytes: int = 0

    @property
    def n_iters(self) -> int:
        return len(self.history) - 1


def _open(backend: str, path: str, adapter: Adapter | None) -> tuple[Adapter, bool]:
    if adapter is not None:
        return adapter, False
    return connect(backend, path), True


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_recursive_arrays(graph, weights, x, y_onehot, n_iters,
                            adapter: Adapter, cache=None) -> DBTrainResult:
    """One recursive query over array-typed columns (sqlite-executable)."""
    tr = tracer_of(adapter)
    with tr.span("train.ingest", representation="array"):
        adapter.create_table("weights", [("w_xh", "text"), ("w_ho", "text")])
        adapter.bulk_insert("weights", [(matrix_to_json(weights["w_xh"]),
                                         matrix_to_json(weights["w_ho"]))])
        adapter.create_table("data", [("img", "text"), ("one_hot", "text")])
        adapter.bulk_insert("data",
                            [(matrix_to_json(x), matrix_to_json(y_onehot))])
    sql = _training_sql(
        graph, "array_calls", adapter,
        lambda: sqlgen.training_query_array_calls(graph, n_iters,
                                                  graph.spec.lr),
        cache, n_iters, graph.spec.lr)
    tr.gauge("recursive_cte_depth", n_iters)
    rows = sorted(adapter.execute(sql))  # (iter, w_xh, w_ho)
    with tr.span("train.decode", rows=len(rows)):
        history = [{"w_xh": json_to_matrix(wxh), "w_ho": json_to_matrix(who)}
                   for _it, wxh, who in rows]
        cte_bytes = sum(len(wxh) + len(who) for _it, wxh, who in rows)
    return DBTrainResult(weights=history[-1], history=history,
                         strategy="recursive", sql=sql, cte_bytes=cte_bytes)


def _train_recursive_listing7(graph, weights, x, y_onehot, n_iters,
                              adapter: Adapter, cache=None) -> DBTrainResult:
    """Listing 7 verbatim — engines whose recursive CTEs are set-at-a-time
    and allow the recursive table inside a nested WITH (duckdb)."""
    tr = tracer_of(adapter)
    with tr.span("train.ingest", representation="relational"):
        relation_io.write_matrix(adapter, "img", x)
        relation_io.write_matrix(adapter, "one_hot", y_onehot)
        relation_io.write_matrix(adapter, "w_xh_init", weights["w_xh"])
        relation_io.write_matrix(adapter, "w_ho_init", weights["w_ho"])
    sql = _training_sql(
        graph, "listing7", adapter,
        lambda: sqlgen.training_query_sql92(graph, n_iters, graph.spec.lr,
                                            adapter.dialect),
        cache, n_iters, graph.spec.lr)
    tr.gauge("recursive_cte_depth", n_iters)
    rows = adapter.execute(sql)  # (iter, id, i, j, v)
    with tr.span("train.decode", rows=len(rows)):
        return _history_from_w_rows(rows, graph, sql, "recursive")


def _train_stepped(graph, weights, x, y_onehot, n_iters,
                   adapter: Adapter, cache=None) -> DBTrainResult:
    """Listing 7's step as INSERT…SELECT, iterated by ``recursive_cte_py``."""
    tr = tracer_of(adapter)
    with tr.span("train.ingest", representation="relational"):
        relation_io.write_matrix(adapter, "img", x)
        relation_io.write_matrix(adapter, "one_hot", y_onehot)
        adapter.create_table("w", [("iter", "integer"), ("id", "integer"),
                                   ("i", "integer"), ("j", "integer"),
                                   ("v", "double precision")])
        for wid, key in ((0, "w_xh"), (1, "w_ho")):
            i, j, v = relation_io.matrix_to_columns(weights[key])
            adapter.insert_columns("w", (np.zeros_like(i),
                                         np.full_like(i, wid), i, j, v))
    step_sql = _training_sql(
        graph, "stepped", adapter,
        lambda: sqlgen.training_step_sql92(graph, graph.spec.lr,
                                           adapter.dialect),
        cache, graph.spec.lr)

    def step(_state, _it):
        t0 = time.perf_counter()
        with tr.span("train.step", iter=_it):
            adapter.execute(step_sql)
        if tr.enabled:
            dt = time.perf_counter() - t0
            tr.observe("train.step_ms", dt * 1e3)
            tr.point("train.step_ms", dt * 1e3, step=_it,
                     strategy="stepped")
        return _state

    recursive_cte_py(None, step, n_iters)
    rows = adapter.execute("select iter, id, i, j, v from w")
    with tr.span("train.decode", rows=len(rows)):
        return _history_from_w_rows(rows, graph, step_sql, "stepped")


def _history_from_w_rows(rows, graph, sql, strategy) -> DBTrainResult:
    """Pivot the ``w(iter, id, i, j, v)`` history relation per iterate —
    one stacked fancy-indexed assignment per weight id instead of a Python
    loop over the (iters × cells)-sized relation."""
    shapes = {0: graph.w_xh.shape, 1: graph.w_ho.shape}
    names = {0: "w_xh", 1: "w_ho"}
    arr = np.asarray(rows, dtype=np.float64)
    t = arr[:, 0].astype(np.int64)
    wid = arr[:, 1].astype(np.int64)
    i = arr[:, 2].astype(np.int64) - 1
    j = arr[:, 3].astype(np.int64) - 1
    n_iters = int(t.max())
    stacks = {}
    for w in (0, 1):
        stack = np.zeros((n_iters + 1,) + shapes[w])
        m = wid == w
        stack[t[m], i[m], j[m]] = arr[m, 4]
        stacks[w] = stack
    history = [{names[w]: stacks[w][k] for w in (0, 1)}
               for k in range(n_iters + 1)]
    return DBTrainResult(weights=history[-1], history=history,
                         strategy=strategy, sql=sql,
                         cte_bytes=len(rows) * 5 * 8)  # (iter,id,i,j,v) rows


def train_in_db(graph, weights, x, y_onehot, n_iters: int, *,
                backend: str = "sqlite", path: str = ":memory:",
                adapter: Adapter | None = None,
                strategy: str = "recursive",
                representation: str = "auto",
                plan_cache_=None, shards: int = 1) -> DBTrainResult:
    """Train the Section-2.2 MLP inside the database.  See module docstring
    for the strategy × backend matrix.  ``plan_cache_``: a
    :class:`~repro_torch.db.plan_cache.PlanCache`, ``None`` for the shared
    persistent default, or ``False`` to render the training SQL fresh.

    ``representation`` picks the matrix encoding of the recursive
    strategy: ``"array"`` forces the Listing-10 array recursion (one row
    of array-typed weight columns — what ``SQLEngine(dialect="array")``
    evaluates with), ``"relational"`` forces Listing 7 verbatim (set
    semantics required — duckdb; sqlite falls back to ``stepped``), and
    ``"auto"`` (default) picks whichever the engine can execute.

    ``weights``, ``x`` and ``y_onehot`` may be tensors on any device: they
    cross to the host once, here (:func:`repro_torch.device.to_host`), and
    the result is numpy float64, as the database computed it.

    ``shards=N`` (N > 1) switches to data-parallel execution
    (:func:`repro_torch.db.shard.train_in_db_sharded`): the batch is
    partitioned across N pooled connections, gradients are reduced by a
    SQL AllReduce on a coordinator connection, and the result is a
    drop-in for the unsharded run (same update — the sum-gradient of the
    unreduced square loss — up to float summation order, ≤ 1e-4 at MNIST
    scale)."""
    if representation not in ("auto", "array", "relational"):
        raise ValueError(f"unknown representation {representation!r}")
    if shards != 1:
        if adapter is not None:
            raise ValueError(
                "shards > 1 needs its own connection pool — pass "
                "backend/path instead of a single adapter")
        if strategy != "recursive":
            raise ValueError(
                f"sharded training replaces the iteration strategy "
                f"(per-step SQL AllReduce); got strategy={strategy!r}")
        from .shard import train_in_db_sharded
        return train_in_db_sharded(graph, weights, x, y_onehot, n_iters,
                                   shards=shards, backend=backend,
                                   path=path, representation=representation,
                                   plan_cache_=plan_cache_)
    weights = {k: to_host(v) for k, v in weights.items()}
    x, y_onehot = to_host(x), to_host(y_onehot)
    adapter, owned = _open(backend, path, adapter)
    if (representation == "array"
            and not getattr(adapter, "supports_python_udfs", True)):
        if owned:
            adapter.close()
        raise ValueError(
            f"the array representation needs Python UDFs, which "
            f"{type(adapter).__name__} cannot register — use "
            f"representation='relational' (or 'auto')")

    def dispatch() -> DBTrainResult:
        if strategy == "recursive":
            if representation == "array" or (
                    representation == "auto"
                    and not adapter.dialect.supports_listing7
                    and getattr(adapter, "supports_python_udfs", True)):
                return _train_recursive_arrays(
                    graph, weights, x, y_onehot, n_iters, adapter,
                    plan_cache_)
            if adapter.dialect.supports_listing7:
                return _train_recursive_listing7(
                    graph, weights, x, y_onehot, n_iters, adapter,
                    plan_cache_)
            # representation="relational" on an engine without Listing 7:
            # the stepped execution is the same math, materialised per step
            return _train_stepped(graph, weights, x, y_onehot, n_iters,
                                  adapter, plan_cache_)
        if strategy == "stepped":
            if representation == "array":
                raise ValueError("the stepped strategy is relational-only "
                                 "(INSERT…SELECT over the w cell relation)")
            return _train_stepped(graph, weights, x, y_onehot, n_iters,
                                  adapter, plan_cache_)
        raise ValueError(f"unknown strategy {strategy!r}")

    tr = tracer_of(adapter)
    try:
        t0 = time.perf_counter()
        with tr.span("train.in_db", strategy=strategy,
                     representation=representation, n_iters=n_iters,
                     backend=adapter.dialect.name):
            res = dispatch()
        if tr.enabled:       # the run's metric_points time-series entries
            dt = time.perf_counter() - t0
            tr.point("train.iter_ms", dt * 1e3 / max(n_iters, 1),
                     step=n_iters, strategy=res.strategy)
            tr.point("train.cte_bytes", res.cte_bytes, step=n_iters)
            cells = adapter.counters.get("ingest_cells")
            if cells:
                tr.point("train.rows_ingested", cells, step=n_iters)
        return res
    finally:
        if owned:
            adapter.close()


# ---------------------------------------------------------------------------
# inference (Listing 8/11)
# ---------------------------------------------------------------------------

def infer_in_db(graph, weights, x, *, backend: str = "sqlite",
                path: str = ":memory:",
                adapter: Adapter | None = None) -> np.ndarray:
    """Forward pass ``m(x)`` in-database; returns the probability matrix."""
    adapter, owned = _open(backend, path, adapter)
    try:
        eng = SQLEngine(adapter=adapter)
        probs, = eng.evaluate([graph.a_ho], {**weights, "img": x})
        return probs
    finally:
        if owned:
            adapter.close()


def predict_in_db(graph, weights, x, *, backend: str = "sqlite",
                  path: str = ":memory:",
                  adapter: Adapter | None = None) -> np.ndarray:
    """Listing 8's ``highestposition`` as a window function: argmax over the
    output relation, computed by the database.  Returns 0-based labels."""
    adapter, owned = _open(backend, path, adapter)
    try:
        with tracer_of(adapter).span("train.predict"):
            eng = SQLEngine(adapter=adapter)
            eng._write_env([graph.a_ho], {**weights, "img": x})
            tail = (f"select q.i, min(q.j) from (select i, j, v,"
                    f" max(v) over (partition by i) as mv"
                    f" from {graph.a_ho.name}) q"
                    f" where q.v = q.mv group by q.i order by q.i")
            sql = sqlgen.to_sql92([graph.a_ho], select=tail,
                                  dialect=eng.dialect)
            rows = adapter.execute(sql)
            return np.asarray([j - 1 for _i, j in rows], dtype=np.int32)
    finally:
        if owned:
            adapter.close()


def loss_trajectory_in_db(graph, history, x, y_onehot, *,
                          backend: str = "sqlite", path: str = ":memory:",
                          adapter: Adapter | None = None) -> np.ndarray:
    """Mean loss of every weight iterate, each evaluated by the database —
    the per-iteration differential signal against ``sgd_step_fn``."""
    adapter, owned = _open(backend, path, adapter)
    try:
        eng = SQLEngine(adapter=adapter)
        fn = eng.eval_fn([graph.loss])
        tr = tracer_of(adapter)
        losses = []
        for k, w in enumerate(history):
            loss = float(np.mean(fn({**w, "img": x, "one_hot": y_onehot})[0]))
            losses.append(loss)
            tr.point("train.loss", loss, step=k, source="trajectory")
        return np.asarray(losses)
    finally:
        if owned:
            adapter.close()
