"""The port's multi-tenant in-database serving against the JAX package's:
the flows of ``tests/test_serving_db.py`` that ``tests/test_torch_db.py``
and ``tests/test_torch_relation_io.py`` do not twin yet.

* ``SQLBatchServer``: every future resolves to its own request's result,
  equal to the reference server's and to a sequential ``evaluate`` within
  ``TOL = 1e-4`` (the reference's bound), including a ragged last
  micro-batch; leaves may be tensors.
* ``SQLEngine.evaluate_batched``: forward, forward + Algorithm-1 gradient
  and the MoE gating layer, in both representations, against ``repro``'s;
  one cached plan for every batch size; broadcast roots; the errors.
* The connection pool: WAL on file pools, cross-thread use, shared-digest
  adoption, fresh ``:memory:`` registry keys.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core import autodiff as jad
from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro.serving.db_serve import SQLBatchServer as JSQLBatchServer
from repro_torch.core import autodiff, nn2sql, sqlgen
from repro_torch.core import expr as E
from repro_torch.db.adapter import ConnectionPool, SQLiteAdapter
from repro_torch.db.plan_cache import PlanCache
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.obs import Tracer, use
from repro_torch.serving import SQLBatchServer
from repro_torch.serving import db_serve

TOL = 1e-4
DIALECTS = [None, "array"]


def close(got, want, atol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


def mlp(n_rows=4, n_hidden=5):
    args = dict(n_rows=n_rows, n_features=6, n_hidden=n_hidden, n_classes=3,
                lr=0.1)
    g = nn2sql.build_graph(nn2sql.MLPSpec(**args))
    jg = jnn.build_graph(jnn.MLPSpec(**args))
    w = {k: np.asarray(v, dtype=np.float64)
         for k, v in jnn.init_weights(jg.spec).items()}
    return g, jg, w


def batch_inputs(nb, n_rows=4, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(nb, n_rows, 6)
    one_hots = np.eye(3)[rng.randint(0, 3, (nb, n_rows))]
    return imgs, one_hots


def sequential(eng, roots, shared, batch_env, nb):
    outs = [eng.evaluate(roots, {**shared, **{n: s[k] for n, s in
                                              batch_env.items()}})
            for k in range(nb)]
    return [np.stack([o[r] for o in outs]) for r in range(len(roots))]


# ---------------------------------------------------------------------------
# the batched differential (one plan, B requests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dialect", DIALECTS)
def test_batched_forward_and_grad_equal_repro(dialect):
    g, jg, w = mlp()
    grads = autodiff.gradients(g.loss, [g.w_xh, g.w_ho])
    jgrads = jad.gradients(jg.loss, [jg.w_xh, jg.w_ho])
    roots = [g.a_ho, g.loss, grads[g.w_xh], grads[g.w_ho]]
    jroots = [jg.a_ho, jg.loss, jgrads[jg.w_xh], jgrads[jg.w_ho]]
    imgs, one_hots = batch_inputs(3)
    be = {"img": imgs, "one_hot": one_hots}
    with SQLEngine(dialect=dialect, plan_cache_=False) as eng, \
            JSQLEngine(dialect=dialect, plan_cache_=False) as jeng:
        got = eng.evaluate_batched(roots, w, be)
        want = jeng.evaluate_batched(jroots, w, be)
        seq = sequential(eng, roots, w, be, 3)
    for k, (a, b, s) in enumerate(zip(got, want, seq)):
        assert a.shape == b.shape == (3,) + roots[k].shape
        close(a, b, msg=f"root {k}")
        close(a, s, msg=f"root {k} sequential")


def _gating(E_):
    x = E_.var("x", (4, 6))
    wg = E_.var("wg", (6, 5))
    gate = E_.softmax(E_.matmul(x, wg, name="logits"))
    mask = E_.argtopk(gate, 2)
    return [E_.hadamard(gate, mask), E_.row_reduce(mask, kind="sum", axis=0)]


@pytest.mark.parametrize("dialect", DIALECTS)
def test_batched_gating_layer_equals_repro(dialect):
    """Softmax → ArgTopK → Hadamard → RowReduce: the MoE gate, whose
    batched spellings partition ranks and denominators per request."""
    rng = np.random.RandomState(11)
    shared = {"wg": rng.randn(6, 5)}
    xs = rng.randn(5, 4, 6)
    with SQLEngine(dialect=dialect, plan_cache_=False) as eng, \
            JSQLEngine(dialect=dialect, plan_cache_=False) as jeng:
        got = eng.evaluate_batched(_gating(E), shared, {"x": xs})
        want = jeng.evaluate_batched(_gating(JE), shared, {"x": xs})
        seq = sequential(eng, _gating(E), shared, {"x": xs}, 5)
    for a, b, s in zip(got, want, seq):
        close(a, b)
        close(a, s)


@pytest.mark.parametrize("dialect", DIALECTS)
def test_batch_of_one(dialect):
    g, _, w = mlp()
    imgs, _ = batch_inputs(1)
    with SQLEngine(dialect=dialect, plan_cache_=False) as eng:
        batched = eng.evaluate_batched([g.a_ho], w, {"img": imgs})
        plain = eng.evaluate([g.a_ho], {**w, "img": imgs[0]})
    assert batched[0].shape == (1,) + g.a_ho.shape
    close(batched[0][0], plain[0])


def test_one_plan_for_every_batch_size():
    g, _, w = mlp()
    cache = PlanCache(path=None)
    with SQLEngine(plan_cache_=cache) as eng:
        for nb in (8, 1, 3):
            imgs, _ = batch_inputs(nb, seed=nb)
            out = eng.evaluate_batched([g.a_ho], w, {"img": imgs})
            assert out[0].shape == (nb,) + g.a_ho.shape
    assert cache.misses == 1 and cache.hits == 2
    cache = PlanCache(path=None)
    with SQLEngine(plan_cache_=cache) as eng:
        imgs, _ = batch_inputs(2)
        eng.evaluate_batched([g.a_ho], w, {"img": imgs})
        eng.evaluate([g.a_ho], {**w, "img": imgs[0]})
    assert cache.misses == 2      # batch:<names> is part of the key


def test_batched_text_equals_repro_and_has_no_batch_size():
    from repro.core import sqlgen as jsqlgen
    g, jg, _ = mlp()
    sql = sqlgen.to_sql([g.a_ho], batch=("img",))
    assert sql == jsqlgen.to_sql([jg.a_ho], batch=("img",))
    for token in ("b = 0", "b = 7", " 8 "):
        assert token not in sql


def test_unbatched_root_broadcasts():
    rng = np.random.RandomState(3)
    x, w = E.var("x", (2, 3)), E.var("w", (3, 3))
    y, s = E.matmul(x, w, name="y"), E.sigmoid(w)
    shared = {"w": rng.randn(3, 3)}
    xs = rng.randn(4, 2, 3)
    with SQLEngine(plan_cache_=False) as eng:
        ys, ss = eng.evaluate_batched([y, s], shared, {"x": xs})
    assert ss.shape == (4, 3, 3)
    for k in range(4):
        close(ss[k], 1.0 / (1.0 + np.exp(-shared["w"])))
        close(ys[k], xs[k] @ shared["w"])


def test_batched_errors():
    a, b = E.var("a", (4, 3)), E.var("b", (4, 3))
    with pytest.raises(NotImplementedError):
        sqlgen.to_sql([E.recurrence(a, b)], batch=("b",))
    x, z = E.var("x", (2, 2)), E.var("z", (2, 2))
    with SQLEngine(plan_cache_=False) as eng:
        with pytest.raises(ValueError, match="batch size"):
            eng.evaluate_batched([E.add(x, z)], {}, {
                "x": np.zeros((2, 2, 2)), "z": np.zeros((3, 2, 2))})
        with pytest.raises(KeyError):
            eng.evaluate_batched([E.sigmoid(x)], {"x": np.zeros((2, 2))},
                                 {"nope": np.zeros((1, 2, 2))})


# ---------------------------------------------------------------------------
# the SQLBatchServer
# ---------------------------------------------------------------------------

def _served(E_):
    x = E_.var("x", (2, 6))
    w1, w2 = E_.var("w1", (6, 5)), E_.var("w2", (5, 3))
    return E_.softmax(E_.matmul(E_.sigmoid(E_.matmul(x, w1, name="h")), w2,
                                name="o"))


def _shared(seed=11):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(6, 5), "w2": rng.randn(5, 3)}


@pytest.mark.parametrize("dialect", DIALECTS)
def test_futures_equal_the_reference_server_and_sequential(dialect):
    shared = _shared()
    xs = [np.random.RandomState(k).randn(2, 6) for k in range(9)]
    with SQLBatchServer([_served(E)], ["x"], shared, pool_size=2,
                        dialect=dialect, plan_cache_=False) as srv:
        futs = [srv.submit({"x": xi}, tenant=f"t{k % 3}")
                for k, xi in enumerate(xs)]
        got = [f.result(timeout=60) for f in futs]
    with JSQLBatchServer([_served(JE)], ["x"], shared, pool_size=2,
                         dialect=dialect, plan_cache_=False) as jsrv:
        want = [jsrv({"x": xi}) for xi in xs]
    with SQLEngine(plan_cache_=False) as eng:
        for xi, res, ref in zip(xs, got, want):
            assert isinstance(res[0], np.ndarray) and res[0].shape == (2, 3)
            close(res[0], ref[0])
            close(res[0], eng.evaluate([_served(E)], {**shared, "x": xi})[0])


def test_ragged_last_micro_batch():
    """max_batch=4, six requests on one worker: the group sequence is
    ragged whatever the window does; every future still resolves to its
    own request's result."""
    shared = _shared(5)
    xs = [np.random.RandomState(40 + k).randn(2, 6) for k in range(6)]
    tr = Tracer()
    with use(tr):
        with SQLBatchServer([_served(E)], ["x"], shared, pool_size=1,
                            max_batch=4, window_ms=20.0,
                            plan_cache_=False) as srv:
            got = [f.result(timeout=60)
                   for f in [srv.submit({"x": xi}) for xi in xs]]
    with SQLEngine(plan_cache_=False) as eng:
        for xi, res in zip(xs, got):
            close(res[0], eng.evaluate([_served(E)], {**shared, "x": xi})[0])
    assert tr.counters["serve.db_requests"] == 6
    assert tr.counters["serve.db_submitted"] == 6
    assert tr.counters["serve.db_batches"] >= 2


def test_tensor_requests_cross_on_the_callers_thread(monkeypatch):
    """Tensors in ``shared_env`` and ``submit`` reach the workers as numpy
    arrays, converted before they are queued."""
    shared = _shared(7)
    xs = [np.random.RandomState(70 + k).randn(2, 6) for k in range(4)]
    seen = []
    real = db_serve.to_host

    def spy(x, dtype=np.float64):
        seen.append(threading.current_thread().name)
        return real(x, dtype)

    monkeypatch.setattr(db_serve, "to_host", spy)
    with SQLBatchServer([_served(E)], ["x"],
                        {k: torch.from_numpy(v) for k, v in shared.items()},
                        pool_size=2, plan_cache_=False) as srv:
        got = [srv({"x": torch.from_numpy(xi).float()}) for xi in xs]
    assert seen and not any(n.startswith("sql-serve") for n in seen)
    with SQLEngine(plan_cache_=False) as eng:
        for xi, res in zip(xs, got):
            want = eng.evaluate([_served(E)], {
                **shared, "x": xi.astype(np.float32)})[0]
            close(res[0], want)


def test_server_errors_like_the_reference():
    shared = _shared()
    with SQLBatchServer([_served(E)], ["x"], shared, pool_size=1,
                        plan_cache_=False) as srv:
        with pytest.raises(KeyError):
            srv.submit({"wrong": np.zeros((2, 6))})
    with pytest.raises(KeyError, match="shared_env"):
        SQLBatchServer([_served(E)], ["x"], {"w1": np.zeros((6, 5))})
    with pytest.raises(KeyError, match="batch_vars"):
        SQLBatchServer([_served(E)], ["nope"], shared)
    srv = SQLBatchServer([_served(E)], ["x"], shared, pool_size=1)
    with pytest.raises(RuntimeError, match="start"):
        srv.submit({"x": np.zeros((2, 6))})
    srv.pool.close()


def test_failed_group_sets_every_future():
    """A batch that fails in the database fails its futures, not the
    worker: a later request is still served."""
    shared = _shared()
    with SQLBatchServer([_served(E)], ["x"], shared, pool_size=1,
                        plan_cache_=False) as srv:
        bad = srv.submit({"x": np.zeros((3, 6))})      # wrong shape
        with pytest.raises(Exception):
            bad.result(timeout=60)
        good = srv({"x": np.ones((2, 6))})
    assert good[0].shape == (2, 3)


# ---------------------------------------------------------------------------
# the connection pool
# ---------------------------------------------------------------------------

def test_file_pool_wal_mode(tmp_path):
    pool = ConnectionPool("sqlite", str(tmp_path / "pool.db"), size=3)
    try:
        assert len(pool) == 3
        for ad in pool:
            mode, = ad.execute("pragma journal_mode")[0]
            assert str(mode).lower() == "wal"
            assert ad._db_key == pool[0]._db_key
    finally:
        pool.close()


def test_cross_thread_connection_use():
    ad = SQLiteAdapter(":memory:")
    ad.create_table("t", (("v", "integer"),))
    errs = []

    def work():
        try:
            for k in range(50):
                ad.execute("insert into t values (?)", (k,))
        except Exception as exc:  # pragma: no cover - the bug
            errs.append(exc)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert ad.execute("select count(*) from t")[0][0] == 200
    ad.close()


def test_shared_digest_adoption_skips_rewrite(tmp_path):
    db = str(tmp_path / "adopt.db")
    x, w = E.var("x", (2, 3)), E.var("w", (3, 2))
    y = E.matmul(x, w, name="y")
    rng = np.random.RandomState(2)
    env = {"x": rng.randn(2, 3), "w": torch.from_numpy(rng.randn(3, 2))}
    e1 = SQLEngine(adapter=SQLiteAdapter(db), plan_cache_=False)
    e1.evaluate([y], env)
    e1.adapter.commit()
    e2 = SQLEngine(adapter=SQLiteAdapter(db), plan_cache_=False)
    info = e2._write_env([y], env)
    assert info["skipped"] == 2 and info["bytes_written"] == 0
    assert e1._write_env([y], env)["skipped"] == 2
    e1.close()
    e2.close()


def test_memory_registry_keys_never_reused():
    seen = set()
    for _ in range(50):
        ad = SQLiteAdapter(":memory:")
        assert ad._db_key not in seen
        seen.add(ad._db_key)
        ad.close()
    x, w = E.var("x", (2, 3)), E.var("w", (3, 2))
    y = E.matmul(x, w, name="y")
    rng = np.random.RandomState(4)
    env = {"x": rng.randn(2, 3), "w": rng.randn(3, 2)}
    for _ in range(3):
        with SQLEngine(plan_cache_=False) as eng:
            out, = eng.evaluate([y], env)
        close(out, env["x"] @ env["w"])
