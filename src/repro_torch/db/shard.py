"""Data-parallel in-DB training: N shard connections + a SQL AllReduce.

PyTorch port of ``repro.db.shard``.  This module mirrors
:mod:`repro_torch.launch.mesh`'s ``data`` axis in the database tier.  The
training batch is partitioned row-wise across N shard connections
(:func:`repro_torch.launch.mesh.shard_slices` — the same contiguous blocks
a device mesh would place along its data axis), each shard evaluates the
cached per-shard gradient plan on its own connection in a
thread-per-shard executor, and the reduction is *itself SQL*:

1. **ship** — every shard's tagged gradient rows (the raw
   ``SQLEngine.evaluate_rows`` output) are inserted into ONE coordinator
   relation ``shard_grads(r, s, i, j, v)``, stamped with the shard index
   ``s`` (the relational concatenation a ``UNION ALL`` over per-shard
   relations would produce);
2. **AllReduce + SGD** — the coordinator runs one statement that groups the
   concatenation on ``(r, i, j)``, sums across shards, and applies the
   update against the resident weight relation ``shard_w``::

       create temp table shard_w_next as
       select w.r, w.i, w.j, w.v - {lr} * coalesce(g.v, 0) as v
         from shard_w w
         left join (select r, i, j, sum(v) as v
                      from shard_grads group by r, i, j) g
           on g.r = w.r and g.i = w.i and g.j = w.j

   (array dialect: ``msum(group_concat(m, '|'))`` per weight —
   the ``magg``-style reduction — followed by ``madd``/``mscale``);
3. **broadcast** — the updated weights are read back once and re-ingested
   into every shard's temp leaves through the bound-parameter delta path.

The gradient of the unreduced square loss is a SUM over examples, so the
sum-reduction makes ``train_in_db(shards=N)`` a drop-in for unsharded
training: same update, the only difference is float summation order.

Every per-shard graph with the same row count renders to the SAME plan —
``build_graph`` is memoised per spec and the plan cache keys on DAG
structure × dialect, never on shard count — so one cached plan serves
every shard (two for an uneven split).

All shard state (weights, batch partition) lives in per-connection TEMP
tables (``SQLEngine(temp_leaves=True)``): shards never collide on a shared
catalog, never contend for the main database's write lock, and never
invalidate each other's matrix caches.  This works identically for N
sqlite files, N ``:memory:`` databases, duckdb cursors over one catalog,
and N postgres sessions.

Weights and data may arrive as tensors on any device: they cross to the
host once, at entry (:func:`repro_torch.device.to_host`), and the result
is numpy float64, as the database computed it.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
import time

import numpy as np

from ..core import autodiff, nn2sql
from ..device import to_host
from ..launch.mesh import AxisSpec, shard_slices
from ..obs import tracer_of
from . import relation_io
from .adapters import ConnectionPool
from .dialect import json_to_matrix, matrix_to_json
from .sql_engine import SQLEngine
from .train import DBTrainResult

#: coordinator relation names (temp tables on the coordinator connection)
GRAD_TABLE = "shard_grads"
WEIGHT_TABLE = "shard_w"
WEIGHT_NEXT = "shard_w_next"

#: the wrt weight leaves, in multi-root tag order (root 0 is the loss,
#: root k is the gradient wrt WEIGHT_NAMES[k-1])
WEIGHT_NAMES = ("w_xh", "w_ho")


def allreduce_statements(representation: str, lr: float
                         ) -> tuple[list[str], str]:
    """The SQL AllReduce + SGD step as coordinator statements, plus the
    read-back query for the broadcast.  Pure SQL in both representations;
    the relational form runs unchanged on sqlite, duckdb and postgres."""
    lr = float(lr)
    if representation == "relational":
        reduce_stmt = (
            f"create temp table {WEIGHT_NEXT} as\n"
            f"select w.r as r, w.i as i, w.j as j,"
            f" w.v - {lr!r} * coalesce(g.v, 0) as v\n"
            f"  from {WEIGHT_TABLE} w\n"
            f"  left join (select r, i, j, sum(v) as v\n"
            f"               from {GRAD_TABLE} group by r, i, j) g\n"
            f"    on g.r = w.r and g.i = w.i and g.j = w.j")
        read_back = f"select r, i, j, v from {WEIGHT_TABLE}"
    else:
        reduce_stmt = (
            f"create temp table {WEIGHT_NEXT} as\n"
            f"select w.r as r, madd(w.m, mscale({-lr!r}, g.m)) as m\n"
            f"  from {WEIGHT_TABLE} w\n"
            f"  join (select r, msum(group_concat(m, '|')) as m\n"
            f"          from {GRAD_TABLE} group by r) g\n"
            f"    on g.r = w.r")
        read_back = f"select r, m from {WEIGHT_TABLE}"
    stmts = [
        f"drop table if exists {WEIGHT_NEXT}",
        reduce_stmt,
        f"delete from {WEIGHT_TABLE}",
        f"insert into {WEIGHT_TABLE} select * from {WEIGHT_NEXT}",
    ]
    return stmts, read_back


def _init_coord_weights(coord, weights, representation: str) -> None:
    """The coordinator's resident weight relation, tagged by root index."""
    if representation == "relational":
        coord.create_table(WEIGHT_TABLE,
                           (("r", "integer"),) + relation_io.MATRIX_COLUMNS,
                           temp=True)
        for k, nm in enumerate(WEIGHT_NAMES, start=1):
            i, j, v = relation_io.matrix_to_columns(weights[nm])
            coord.insert_columns(WEIGHT_TABLE,
                                 (np.full_like(i, k), i, j, v))
    else:
        coord.create_table(WEIGHT_TABLE,
                           (("r", "integer"),) + relation_io.ARRAY_COLUMNS,
                           temp=True)
        coord.bulk_insert(WEIGHT_TABLE,
                          [(k, matrix_to_json(weights[nm]))
                           for k, nm in enumerate(WEIGHT_NAMES, start=1)])


def _decode_weights(rows, shapes: dict, representation: str) -> dict:
    """Read-back rows → ``{name: dense}`` (the broadcast payload)."""
    out = {nm: np.zeros(shapes[nm], dtype=np.float64) for nm in WEIGHT_NAMES}
    if representation == "relational":
        arr = np.asarray(rows, dtype=np.float64)
        r = arr[:, 0].astype(np.int64)
        i = arr[:, 1].astype(np.int64) - 1
        j = arr[:, 2].astype(np.int64) - 1
        for k, nm in enumerate(WEIGHT_NAMES, start=1):
            m = r == k
            out[nm][i[m], j[m]] = arr[m, 3]
    else:
        for r, m in rows:
            out[WEIGHT_NAMES[int(r) - 1]] = json_to_matrix(m)
    return out


def _loss_sum(rows_per_shard, representation: str) -> float:
    """Total of the (unreduced, elementwise-square) loss cells across
    every shard's result rows — tagged ``r == 0`` in the multi-root
    output.  Divided by the full batch's cell count it is exactly the
    mean loss unsharded training reports."""
    total = 0.0
    for rows in rows_per_shard:
        for row in rows:
            if int(row[0]) == 0:
                if representation == "relational":
                    total += float(row[3])
                else:
                    total += float(json_to_matrix(row[1]).sum())
    return total


def train_in_db_sharded(graph, weights, x, y_onehot, n_iters: int, *,
                        shards: int, backend: str = "sqlite",
                        path: str = ":memory:",
                        representation: str = "auto",
                        plan_cache_=None,
                        pool: ConnectionPool | None = None
                        ) -> DBTrainResult:
    """Data-parallel ``train_in_db``: partition the batch across ``shards``
    connections, evaluate the cached per-shard gradient plan concurrently,
    AllReduce + SGD in SQL on a coordinator connection, broadcast.

    A drop-in for unsharded training — reached as
    ``train_in_db(..., shards=N)`` — matching it ≤ 1e-4 (only float
    summation order differs; with a fixed partition the run itself is
    deterministic).  ``representation="auto"`` uses the relational cell
    representation, which runs on every backend including UDF-less
    postgres; ``"array"`` rides the §5 array codec where Python UDFs
    register.  ``weights``, ``x`` and ``y_onehot`` may be tensors on any
    device; they cross to the host here, once."""
    if shards < 1:
        raise ValueError(f"need shards >= 1, got {shards}")
    if representation not in ("auto", "relational", "array"):
        raise ValueError(f"unknown representation {representation!r}")
    rep = "relational" if representation == "auto" else representation

    x, y_onehot = to_host(x), to_host(y_onehot)
    axis = AxisSpec("data", shards)
    slices = shard_slices(x.shape[0], axis.size)

    # one gradient DAG per DISTINCT shard size: equal-size shards share the
    # graph object (build_graph is memoised) and therefore ONE cached plan
    roots_by_size: dict[int, list] = {}
    for sl in slices:
        n = sl.stop - sl.start
        if n not in roots_by_size:
            sg = nn2sql.build_graph(
                dataclasses.replace(graph.spec, n_rows=n))
            grads = autodiff.gradients(sg.loss, [sg.w_xh, sg.w_ho])
            roots_by_size[n] = [sg.loss, grads[sg.w_xh], grads[sg.w_ho]]

    owned = pool is None
    if owned:
        pool = ConnectionPool(backend, path, size=shards)
    elif len(pool) < shards:
        raise ValueError(f"pool has {len(pool)} connections, need {shards}")
    coord = pool[0]
    if rep == "array" and not getattr(coord, "supports_python_udfs", True):
        raise ValueError(
            f"the array representation needs Python UDFs, which the "
            f"{type(coord).__name__} backend cannot register — use "
            f"representation='relational'")
    dialect = "array" if rep == "array" else None
    engines = [SQLEngine(adapter=pool[k], plan_cache_=plan_cache_,
                         dialect=dialect, temp_leaves=True)
               for k in range(shards)]

    cur = {nm: to_host(weights[nm]) for nm in WEIGHT_NAMES}
    shapes = {nm: cur[nm].shape for nm in WEIGHT_NAMES}
    loss_cells = float(y_onehot.size)
    stmts, read_back = allreduce_statements(rep, graph.spec.lr)
    tr = tracer_of(coord)
    traffic_rows = 0
    t0 = time.perf_counter()
    try:
        with tr.span("train.in_db", strategy="sharded", representation=rep,
                     n_iters=n_iters, backend=coord.dialect.name,
                     shards=shards, axis=axis.name):
            relation_io.create_shard_grads(coord, GRAD_TABLE, rep)
            _init_coord_weights(coord, cur, rep)
            # warm the shared plan cache on the main thread so shard
            # threads never race the same miss
            for roots in roots_by_size.values():
                engines[0]._render(roots)
            history = [dict(cur)]

            def grad_rows(k: int) -> list[tuple]:
                sl = slices[k]
                eng = engines[k]
                env = {**cur, "img": x[sl], "one_hot": y_onehot[sl]}
                with tracer_of(eng.adapter).span(
                        "shard.grad", shard=k, rows=sl.stop - sl.start):
                    return eng.evaluate_rows(
                        roots_by_size[sl.stop - sl.start], env)

            with ThreadPoolExecutor(max_workers=shards) as executor:
                for it in range(n_iters):
                    t_it = time.perf_counter()
                    with tr.span("shard.step", iter=it, shards=shards):
                        results = list(executor.map(grad_rows,
                                                    range(shards)))
                        with tr.span("shard.ship") as sp:
                            coord.execute(f"delete from {GRAD_TABLE}")
                            shipped = 0
                            for k, rows in enumerate(results):
                                shipped += relation_io.ship_grad_rows(
                                    coord, GRAD_TABLE, k, rows, rep)
                            sp.set(rows=shipped)
                            traffic_rows += shipped
                        with tr.span("shard.allreduce", shards=shards,
                                     op="sum"):
                            for stmt in stmts:
                                coord.execute(stmt)
                        with tr.span("shard.broadcast"):
                            cur = _decode_weights(coord.execute(read_back),
                                                  shapes, rep)
                        history.append(dict(cur))
                    if tr.enabled:
                        dt = time.perf_counter() - t_it
                        tr.observe("shard.iter_ms", dt * 1e3)
                        tr.point("shard.iter_ms", dt * 1e3, step=it,
                                 shards=shards)
                        tr.point("train.loss",
                                 _loss_sum(results, rep) / loss_cells,
                                 step=it, strategy="sharded")
        if tr.enabled:
            dt = time.perf_counter() - t0
            tr.point("train.iter_ms", dt * 1e3 / max(n_iters, 1),
                     step=n_iters, strategy="sharded")
            stats = SQLEngine.merged_stats(engines)
            cells = stats.get("adapter", {}).get("ingest_cells")
            if cells:
                tr.point("train.rows_ingested", cells, step=n_iters)
        return DBTrainResult(
            weights=history[-1], history=history, strategy="sharded",
            sql=stmts[1],
            # cross-connection AllReduce traffic: every shipped gradient
            # row is (r, s, i, j, v) — the sharded twin of the recursive
            # strategies' materialised-iterate accounting
            cte_bytes=traffic_rows * 5 * 8)
    finally:
        if owned:
            pool.close()
