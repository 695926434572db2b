"""The port's data-parallel in-database training against the JAX package's:
the flows of ``tests/test_shard_db.py`` on the same seeded inputs.

* ``launch.mesh.shard_slices`` / ``AxisSpec`` equal the reference's.
* ``allreduce_statements`` renders the reference's SQL text, byte for byte.
* ``train_in_db(shards=N)`` trajectories equal ``repro``'s within
  ``TOL = 1e-4`` (the reference's acceptance bound; both packages run the
  same SQL on the same sqlite, so they agree far closer) at shards 1, 3
  and 4, on an uneven split and in both representations; and within the
  reference's own ``1e-9`` of the port's unsharded stepped run.
* The plan cache never keys on the shard count.
* Weights and data may be tensors; they cross to the host at entry.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import nn2sql as jnn
from repro.db import shard as jshard
from repro.db.train import train_in_db as jtrain_in_db
from repro.launch import mesh as jmesh
from repro_torch.core import nn2sql
from repro_torch.db import shard
from repro_torch.db.plan_cache import PlanCache
from repro_torch.db.shard import (WEIGHT_NAMES, allreduce_statements,
                                  train_in_db_sharded)
from repro_torch.db.train import train_in_db
from repro_torch.launch.mesh import AxisSpec, shard_slices
from repro_torch.obs import Tracer, use

TOL = 1e-4
SAME = 1e-9     # tests/test_shard_db.py: only summation order differs


def problem(n_rows=12, lr=0.05, seed=11):
    """``tests/test_shard_db.py``'s ``_problem`` for both packages."""
    rng = np.random.RandomState(seed)
    args = dict(n_rows=n_rows, n_features=6, n_hidden=5, n_classes=3, lr=lr)
    g = nn2sql.build_graph(nn2sql.MLPSpec(**args))
    jg = jnn.build_graph(jnn.MLPSpec(**args))
    w = {"w_xh": rng.randn(6, 5) * 0.3, "w_ho": rng.randn(5, 3) * 0.3}
    x = rng.randn(n_rows, 6)
    y = np.eye(3)[rng.randint(0, 3, n_rows)]
    return g, jg, w, x, y


def close(got, want, atol=TOL, msg=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# the partition and the AllReduce SQL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,shards", [(10, 4), (8, 4), (11, 3), (5, 1),
                                         (7, 7)])
def test_shard_slices_equal_the_reference(rows, shards):
    got = shard_slices(rows, shards)
    assert got == jmesh.shard_slices(rows, shards)
    assert got[0].start == 0 and got[-1].stop == rows
    assert all(a.stop == b.start for a, b in zip(got, got[1:]))
    assert max(s.stop - s.start for s in got) - min(
        s.stop - s.start for s in got) <= 1


def test_bad_partitions_and_axes_rejected_like_the_reference():
    for bad in ((4, 0), (3, 4)):
        for fn in (shard_slices, jmesh.shard_slices):
            with pytest.raises(ValueError):
                fn(*bad)
    assert AxisSpec("data", 4) == AxisSpec("data", 4)
    assert AxisSpec("data", 4).size == jmesh.AxisSpec("data", 4).size == 4
    with pytest.raises(ValueError, match="size >= 1"):
        AxisSpec("data", 0)


@pytest.mark.parametrize("rep", ["relational", "array"])
@pytest.mark.parametrize("lr", [0.05, 0.1, 1e-3])
def test_allreduce_sql_equals_the_reference(rep, lr):
    stmts, read_back = allreduce_statements(rep, lr)
    assert (stmts, read_back) == jshard.allreduce_statements(rep, lr)
    if rep == "relational":
        assert "group by r, i, j" in stmts[1] and "sum(v)" in stmts[1]
        assert read_back == "select r, i, j, v from shard_w"
    else:
        assert "msum(group_concat(m, '|'))" in stmts[1]
        assert "madd" in stmts[1] and "mscale" in stmts[1]
        assert read_back == "select r, m from shard_w"
    assert repr(float(lr)) in stmts[1]


# ---------------------------------------------------------------------------
# trajectories against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", ["relational", "array"])
@pytest.mark.parametrize("shards,rows", [(1, 12), (3, 12), (4, 12),
                                         (3, 11)])
def test_sharded_trajectory_equals_repro(shards, rows, rep):
    g, jg, w, x, y = problem(n_rows=rows)
    got = train_in_db_sharded(g, w, x, y, 2, shards=shards,
                              representation=rep, plan_cache_=False)
    want = jshard.train_in_db_sharded(jg, w, x, y, 2, shards=shards,
                                      representation=rep, plan_cache_=False)
    assert got.strategy == want.strategy == "sharded"
    assert got.sql == want.sql and got.cte_bytes == want.cte_bytes
    assert len(got.history) == len(want.history) == 3
    for it, (h, jh) in enumerate(zip(got.history, want.history)):
        for k in WEIGHT_NAMES:
            assert h[k].dtype == np.float64
            close(h[k], jh[k], msg=f"iter {it} {k}")


def test_shards_4_matches_unsharded_stepped_run():
    """The reference's acceptance flow, through ``train_in_db``."""
    g, jg, w, x, y = problem()
    ref = train_in_db(g, w, x, y, 3, strategy="stepped", plan_cache_=False)
    got = train_in_db(g, w, x, y, 3, shards=4, plan_cache_=False)
    jgot = jtrain_in_db(jg, w, x, y, 3, shards=4, plan_cache_=False)
    assert got.strategy == "sharded" and got.n_iters == 3
    assert len(got.history) == len(ref.history)
    for k in WEIGHT_NAMES:
        close(got.weights[k], ref.weights[k], atol=SAME, msg=k)
        close(got.weights[k], jgot.weights[k], msg=k)


def test_uneven_split_and_shard_counts_agree():
    g, _, w, x, y = problem(n_rows=11)
    ref = train_in_db(g, w, x, y, 2, strategy="stepped", plan_cache_=False)
    one = train_in_db_sharded(g, w, x, y, 2, shards=1, plan_cache_=False)
    three = train_in_db_sharded(g, w, x, y, 2, shards=3, plan_cache_=False)
    for k in WEIGHT_NAMES:
        close(three.weights[k], ref.weights[k], atol=SAME, msg=k)
        close(three.weights[k], one.weights[k], atol=SAME, msg=k)


def test_repeat_runs_are_bitwise_identical():
    g, _, w, x, y = problem()
    a = train_in_db_sharded(g, w, x, y, 2, shards=3, plan_cache_=False)
    b = train_in_db_sharded(g, w, x, y, 2, shards=3, plan_cache_=False)
    for k in WEIGHT_NAMES:
        assert np.array_equal(a.weights[k], b.weights[k])


def test_array_representation_matches_relational():
    g, _, w, x, y = problem()
    rel = train_in_db_sharded(g, w, x, y, 2, shards=2,
                              representation="relational", plan_cache_=False)
    arr = train_in_db_sharded(g, w, x, y, 2, shards=2,
                              representation="array", plan_cache_=False)
    for k in WEIGHT_NAMES:
        close(arr.weights[k], rel.weights[k], atol=SAME, msg=k)


def test_tensors_cross_once_and_give_the_same_run():
    g, _, w, x, y = problem()
    arrays = train_in_db_sharded(g, w, x, y, 2, shards=2, plan_cache_=False)
    tensors = train_in_db(
        g, {k: torch.from_numpy(v).float() for k, v in w.items()},
        torch.from_numpy(x).float(), torch.from_numpy(y).float(), 2,
        shards=2, plan_cache_=False)
    floats = train_in_db_sharded(
        g, {k: v.astype(np.float32) for k, v in w.items()},
        x.astype(np.float32), y.astype(np.float32), 2, shards=2,
        plan_cache_=False)
    for k in WEIGHT_NAMES:
        assert isinstance(tensors.weights[k], np.ndarray)
        assert np.array_equal(tensors.weights[k], floats.weights[k])
        close(tensors.weights[k], arrays.weights[k], msg=k)


def test_traffic_accounted_like_the_reference():
    g, jg, w, x, y = problem()
    res = train_in_db_sharded(g, w, x, y, 2, shards=2, plan_cache_=False)
    # 2 iterations × 2 shards × (30 + 15) gradient cells, 5 values a row
    assert res.cte_bytes == 2 * 2 * (6 * 5 + 5 * 3) * 5 * 8
    assert "group by r, i, j" in res.sql


def test_guard_rails():
    g, _, w, x, y = problem()
    with pytest.raises(ValueError, match="shards >= 1"):
        train_in_db_sharded(g, w, x, y, 1, shards=0)
    with pytest.raises(ValueError, match="representation"):
        train_in_db_sharded(g, w, x, y, 1, shards=2, representation="csr")
    with pytest.raises(ValueError, match="strategy"):
        train_in_db(g, w, x, y, 1, shards=2, strategy="stepped")
    from repro_torch.db import ConnectionPool, connect
    ad = connect("sqlite")
    try:
        with pytest.raises(ValueError, match="connection pool"):
            train_in_db(g, w, x, y, 1, shards=2, adapter=ad)
    finally:
        ad.close()
    pool = ConnectionPool("sqlite", size=1)
    try:
        with pytest.raises(ValueError, match="pool has 1"):
            train_in_db_sharded(g, w, x, y, 1, shards=2, pool=pool)
    finally:
        pool.close()


def test_spans_and_time_series_match_the_reference():
    """The ``shard.*`` spans and ``metric_points`` of one traced run carry
    the reference's names, counts and loss values."""
    from repro import obs as jobs

    g, jg, w, x, y = problem()
    tr, jtr = Tracer(), jobs.Tracer()
    with use(tr):
        train_in_db_sharded(g, w, x, y, 2, shards=2, plan_cache_=False)
    with jobs.use(jtr):
        jshard.train_in_db_sharded(jg, w, x, y, 2, shards=2,
                                   plan_cache_=False)

    def names(t):
        return sorted(s.name for s in t.spans
                      if s.name.startswith(("shard.", "train.")))

    assert names(tr) == names(jtr)
    assert names(tr).count("shard.grad") == 4
    got = {(p.metric, p.step) for p in tr.points}
    assert got == {(p.metric, p.step) for p in jtr.points}
    loss = [p.value for p in tr.points if p.metric == "train.loss"]
    jloss = [p.value for p in jtr.points if p.metric == "train.loss"]
    close(np.array(loss), np.array(jloss))
    assert loss[1] < loss[0]


# ---------------------------------------------------------------------------
# the plan cache: the shard count never enters the key
# ---------------------------------------------------------------------------

def test_equal_shards_share_one_plan(tmp_path):
    cache = PlanCache(path=str(tmp_path / "plans.db"))
    g, _, w, x, y = problem(n_rows=12)
    train_in_db_sharded(g, w, x, y, 2, shards=4, plan_cache_=cache)
    assert cache.misses == 1
    assert cache.hits >= 3


def test_shard_count_not_in_key(tmp_path):
    cache = PlanCache(path=str(tmp_path / "plans.db"))
    g, _, w, x, y = problem(n_rows=12)
    train_in_db_sharded(g, w, x, y, 1, shards=2, plan_cache_=cache)
    misses = cache.misses
    g24, _, _, x24, y24 = problem(n_rows=24, seed=3)
    train_in_db_sharded(g24, w, x24, y24, 1, shards=4, plan_cache_=cache)
    assert cache.misses == misses


def test_module_surface():
    import repro_torch.db as db
    assert db.train_in_db_sharded is train_in_db_sharded
    assert db.shard is shard
    assert shard.WEIGHT_NAMES == jshard.WEIGHT_NAMES
    assert (shard.GRAD_TABLE, shard.WEIGHT_TABLE, shard.WEIGHT_NEXT) == (
        jshard.GRAD_TABLE, jshard.WEIGHT_TABLE, jshard.WEIGHT_NEXT)
