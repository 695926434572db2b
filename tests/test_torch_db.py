"""The port's in-database tier against the JAX package on the same seeded
inputs: the flows of ``tests/test_db_backend.py`` and
``tests/test_representation_matrix.py`` (the DAG zoo's SQL modules aside).

* ``Engine("sql")`` of the port, relational (SQL-92 cell relations) and
  array (the Listing-10 UDF extension), against JAX's ``Engine("dense")``
  within ``TOL = 1e-4``, the reference's engine differential bound
  (``tests/test_db_backend.py``): the database computes in float64, JAX in
  float32.
* ``train_in_db``'s recursive, Listing-7 stepped and array trajectories
  against ``repro``'s within ``EXACT = 1e-12``: both packages render the
  same SQL (asserted) and run it on the same sqlite with the same numpy
  UDFs, so the iterates should agree to the bit; 1e-12 leaves room only
  for an ingestion path whose text→real parse is one ulp off.
* ``nn2sql.train`` with ``Engine("sql")`` returns float32 tensors on the
  engine's device; tensors (the port's) and arrays cross to the database
  through one helper, ``repro_torch.device.to_host``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro.core import sgd_step_fn as jsgd
from repro.db import train as jtrain
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro_torch.core import Engine, nn2sql, sgd_step_fn
from repro_torch.core import expr as E
from repro_torch.db import relation_io
from repro_torch.db.sql_engine import SQLEngine, _digest
from repro_torch.db.train import (infer_in_db, loss_trajectory_in_db,
                                  predict_in_db, train_in_db)
from repro_torch.device import to_host

TOL = 1e-4
EXACT = 1e-12
REPS = {"relational": {}, "array": {"dialect": "array"}}


def close(got, want, atol=TOL, msg=""):
    np.testing.assert_allclose(to_host(got), to_host(np.asarray(want)),
                               atol=atol, rtol=0, err_msg=msg)


def mlp(n_rows=20, n_hidden=6, lr=0.05, features=4, classes=3, seed=7):
    """The Section-2.2 MLP in both packages, Iris-shaped by default."""
    rng = np.random.RandomState(seed)
    args = dict(n_rows=n_rows, n_features=features, n_hidden=n_hidden,
                n_classes=classes, lr=lr)
    g = nn2sql.build_graph(nn2sql.MLPSpec(**args))
    jg = jnn.build_graph(jnn.MLPSpec(**args))
    w0 = {k: np.array(v) for k, v in jnn.init_weights(jg.spec).items()}
    x = rng.rand(n_rows, features).astype(np.float32)
    labels = rng.randint(0, classes, n_rows)
    y = np.eye(classes, dtype=np.float32)[labels]
    return g, jg, w0, x, y, labels


def jax_dense_history(jg, w0, x, y, n_iters):
    step = jsgd(jg.loss, [jg.w_xh, jg.w_ho], jg.spec.lr, JEngine("dense"))
    w = {k: jnp.asarray(v) for k, v in w0.items()}
    env = {"img": jnp.asarray(x), "one_hot": jnp.asarray(y)}
    hist, losses = [{k: np.asarray(v) for k, v in w.items()}], []
    for _ in range(n_iters):
        w, loss = step(w, env)
        losses.append(float(loss))
        hist.append({k: np.asarray(v) for k, v in w.items()})
    return hist, np.asarray(losses)


def jax_dense(roots, env):
    return [np.asarray(o) for o in JEngine("dense").eval_fn(roots)(
        {k: jnp.asarray(v, jnp.float32) for k, v in env.items()})]


# ---------------------------------------------------------------------------
# Engine("sql") against JAX dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
def test_forward_and_algorithm1_gradients_match_jax_dense(rep):
    g, jg, w0, x, y, _ = mlp()
    env = {**w0, "img": x, "one_hot": y}
    eng = Engine("sql", device="cpu", **REPS[rep])
    probs, = eng.evaluate([g.a_ho], env)
    assert isinstance(probs, np.ndarray) and probs.dtype == np.float64
    close(probs, jax_dense([jg.a_ho], env)[0])
    loss, grads = eng.value_and_grad_fn(g.loss, [g.w_xh, g.w_ho])(env)
    jl, jgr = JEngine("dense").value_and_grad_fn(jg.loss, [jg.w_xh, jg.w_ho])(
        {k: jnp.asarray(v) for k, v in env.items()})
    close(loss, jl)
    for k in ("w_xh", "w_ho"):
        close(grads[k], jgr[k], msg=k)
    eng.close()


@pytest.mark.parametrize("rep", REPS)
def test_tensors_and_arrays_are_the_same_leaves(rep):
    """A float32 tensor leaf and its numpy array give the same result and
    the same digest, so a tensor env skips unchanged leaves as arrays do."""
    g, _, w0, x, y, _ = mlp()
    env = {**w0, "img": x, "one_hot": y}
    tenv = {k: torch.from_numpy(v) for k, v in env.items()}
    eng = SQLEngine(plan_cache_=False, **REPS[rep])
    (a,) = eng.evaluate([g.loss], env)
    info = eng._write_env([g.loss], tenv)
    assert info["skipped"] == info["leaves"] == 4
    (b,) = eng.evaluate([g.loss], tenv)
    np.testing.assert_array_equal(a, b)
    for v in env.values():
        assert _digest(torch.from_numpy(v), rep) == _digest(v, rep)
    eng.close()


def _building_block_roots(E_):
    a, b, c = E_.var("a", (3, 4)), E_.var("b", (3, 4)), E_.var("c", (4, 2))
    return [E_.matmul(a, c), E_.hadamard(a, b), E_.add(a, b), E_.sub(a, b),
            E_.scale(2.5, a), E_.transpose(a), E_.sigmoid(a), E_.square(a),
            E_.relu(a), E_.add(E_.const(3.0, (3, 4)), a)]


@pytest.mark.parametrize("rep", REPS)
def test_building_blocks_each_op(rep):
    rng = np.random.RandomState(11)
    env = {"a": rng.randn(3, 4), "b": rng.randn(3, 4), "c": rng.randn(4, 2)}
    outs = Engine("sql", device="cpu", **REPS[rep]).evaluate(
        _building_block_roots(E), env)
    for k, (s, d) in enumerate(zip(outs, jax_dense(
            _building_block_roots(JE), env))):
        close(s, d, msg=f"root {k}")


def _prim_case(E_, prim, rng):
    """``tests/test_representation_matrix.py``'s case generator over the
    IR module ``E_``: the same rng draws give the same DAG and leaves."""
    r, c = int(rng.randint(2, 6)), int(rng.randint(2, 5))
    x = E_.var("x", (r, c))
    env = {"x": rng.randn(r, c) * 0.7}
    if prim == "algebra":
        y = E_.var("y", (r, c))
        z = E_.var("z", (c, int(rng.randint(2, 5))))
        env["y"] = rng.randn(r, c)
        env["z"] = rng.randn(c, z.shape[1])
        roots = [E_.matmul(E_.hadamard(x, y), z), E_.sub(x, y),
                 E_.scale(1.5, E_.transpose(x)), E_.sigmoid(x), E_.relu(x),
                 E_.square(x),
                 E_.recip(E_.add(E_.square(x), E_.const(1.0, (r, c)))),
                 E_.add(E_.const(2.0, (r, c)), x)]
    elif prim == "rowreduce":
        roots = [E_.row_reduce(x, "sum", 1), E_.row_reduce(x, "sum", 0),
                 E_.row_reduce(x, "max", 1), E_.row_reduce(x, "max", 0)]
    elif prim == "softmax":
        roots = [E_.softmax(x)]
    elif prim == "argtopk":
        roots = [E_.argtopk(x, int(rng.randint(1, c + 1)))]
    elif prim == "gather":
        s = int(rng.randint(2, 6))
        env["idx"] = rng.randint(0, r, size=(s, 1)).astype(np.float64)
        roots = [E_.gather(x, E_.var("idx", (s, 1)))]
    elif prim == "scatter":
        n_rows = int(rng.randint(2, 7))
        env["idx"] = rng.randint(0, n_rows, size=(r, 1)).astype(np.float64)
        roots = [E_.scatter(x, E_.var("idx", (r, 1)), n_rows)]
    elif prim == "rowshift":
        roots = [E_.row_shift(x, 1), E_.row_shift(x, -1),
                 E_.row_shift(x, int(rng.randint(2, r + 1)))]
    else:
        a, b = E_.var("a", (r, c)), E_.var("b", (r, c))
        env["a"] = rng.rand(r, c) * 0.5 + 0.2
        env["b"] = rng.randn(r, c)
        roots = [E_.recurrence(a, b), E_.recurrence(a, b, reverse=True)]
    return roots, env


PRIMS = ("algebra", "rowreduce", "softmax", "argtopk", "gather", "scatter",
         "rowshift", "recurrence")


@pytest.fixture(scope="module")
def sql_engines():
    engines = {rep: SQLEngine(plan_cache_=False, **opts)
               for rep, opts in REPS.items()}
    yield engines
    for eng in engines.values():
        eng.close()


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("prim", PRIMS)
def test_primitive_forward_matrix(prim, seed, rep, sql_engines):
    roots, env = _prim_case(E, prim, np.random.RandomState(100 * seed + 7))
    jroots, jenv = _prim_case(JE, prim, np.random.RandomState(100 * seed + 7))
    for k, (s, d) in enumerate(zip(sql_engines[rep].evaluate(roots, env),
                                   jax_dense(jroots, jenv))):
        close(s, d, msg=f"{prim}[{seed}] root {k}")


def test_var_only_root():
    env = {"a": np.random.RandomState(3).randn(2, 2)}
    out, = Engine("sql", device="cpu").evaluate([E.var("a", (2, 2))], env)
    np.testing.assert_array_equal(out, env["a"])


def test_leaf_digest_invalidated_by_direct_table_write():
    g, _, w0, x, y, _ = mlp(n_rows=6, n_hidden=3)
    eng = Engine("sql", device="cpu")
    probs1, = eng.evaluate([g.a_ho], {**w0, "img": x})
    train_in_db(g, w0, x + 0.5, y, 1, adapter=eng._sql.adapter,
                strategy="stepped")   # overwrites the img relation
    probs2, = eng.evaluate([g.a_ho], {**w0, "img": x})
    np.testing.assert_allclose(probs2, probs1, atol=1e-12)
    eng._sql.adapter.insert_columns(
        "img", relation_io.matrix_to_columns(np.ones_like(x)))
    probs3, = eng.evaluate([g.a_ho], {**w0, "img": x})
    np.testing.assert_allclose(probs3, probs1, atol=1e-12)


def test_leaf_digest_separates_shape_and_dtype():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    assert _digest(a, "relational") != _digest(a.reshape(3, 2), "relational")
    assert _digest(a, "relational") != _digest(a.astype(np.float32),
                                               "relational")
    assert _digest(a, "relational") != _digest(a, "array")
    eng = SQLEngine(plan_cache_=False)
    out1, = eng.evaluate([E.var("r23", (2, 3))], {"r23": a})
    np.testing.assert_array_equal(out1, a)
    eng.adapter.matrix_digests["r32"] = eng.adapter.matrix_digests["r23"]
    out2, = eng.evaluate([E.var("r32", (3, 2))], {"r32": a.reshape(3, 2)})
    eng.close()
    np.testing.assert_array_equal(out2, a.reshape(3, 2))


@pytest.mark.parametrize("rep", REPS)
def test_sgd_step_matches_jax_dense(rep):
    """One SGD step through the SQL backend's value_and_grad, the weight
    update on the host (Listing 7's final select), from tensor weights."""
    g, jg, w0, x, y, _ = mlp(n_rows=8, n_hidden=4, features=5, lr=0.1,
                             seed=6)
    eng = Engine("sql", device="cpu", **REPS[rep])
    step = sgd_step_fn(g.loss, [g.w_xh, g.w_ho], g.spec.lr, eng)
    w1, loss = step({k: torch.from_numpy(v) for k, v in w0.items()},
                    {"img": x, "one_hot": y})
    assert isinstance(loss, float)
    hist, losses = jax_dense_history(jg, w0, x, y, 1)
    assert abs(loss - losses[0]) < TOL
    for k in ("w_xh", "w_ho"):
        assert isinstance(w1[k], np.ndarray)
        close(w1[k], hist[1][k], msg=k)
    eng.close()


# ---------------------------------------------------------------------------
# in-database training: the port against JAX dense and against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", REPS)
def test_nn2sql_train_in_db_matches_jax_dense(rep):
    g, jg, w0, x, y, _ = mlp()
    tw0 = {k: torch.from_numpy(v) for k, v in w0.items()}
    final, hist = nn2sql.train(g, tw0, torch.from_numpy(x),
                               torch.from_numpy(y), 3,
                               Engine("sql", device="cpu", **REPS[rep]),
                               materialize_history=True)
    ref, _ = jax_dense_history(jg, w0, x, y, 3)
    for k in ("w_xh", "w_ho"):
        assert final[k].dtype == torch.float32
        assert final[k].device.type == "cpu"
        assert hist[k].shape == (4,) + final[k].shape
        close(final[k], ref[3][k], msg=k)
        for it in range(4):
            close(hist[k][it], ref[it][k], msg=f"iter {it} {k}")
    final2, none = nn2sql.train(g, tw0, x, y, 3, Engine("sql", device="cpu"))
    assert none is None and final2["w_xh"].dtype == torch.float32


CASES = {"recursive": {}, "array": {"representation": "array"},
         "stepped": {"strategy": "stepped"}}


@pytest.mark.parametrize("case", CASES)
def test_train_in_db_trajectory_equals_repro(case):
    g, jg, w0, x, y, _ = mlp()
    n = 4
    res = train_in_db(g, {k: torch.from_numpy(v) for k, v in w0.items()},
                      torch.from_numpy(x), y, n, plan_cache_=False,
                      **CASES[case])
    jres = jtrain.train_in_db(jg, w0, x, y, n, plan_cache_=False,
                              **CASES[case])
    assert res.strategy == jres.strategy
    assert res.sql == jres.sql
    assert res.n_iters == n and res.cte_bytes == jres.cte_bytes
    for it in range(n + 1):
        for k in ("w_xh", "w_ho"):
            close(res.history[it][k], jres.history[it][k], atol=EXACT,
                  msg=f"iter {it} {k}")
    ref, ref_losses = jax_dense_history(jg, w0, x, y, n)
    for k in ("w_xh", "w_ho"):
        close(res.weights[k], ref[n][k], msg=k)
    traj = loss_trajectory_in_db(g, res.history, x, y)
    close(traj, jtrain.loss_trajectory_in_db(jg, jres.history, x, y),
          atol=EXACT)
    close(traj[:n], ref_losses)
    assert traj[n] < traj[0]


def test_train_in_db_arguments():
    g, _, w0, x, y, _ = mlp(n_rows=4, n_hidden=2)
    with pytest.raises(ValueError, match="strategy"):
        train_in_db(g, w0, x, y, 1, strategy="magic")
    with pytest.raises(ValueError, match="relational-only"):
        train_in_db(g, w0, x, y, 1, strategy="stepped",
                    representation="array")
    with pytest.raises(ValueError, match="representation"):
        train_in_db(g, w0, x, y, 1, representation="sparse")
    two = train_in_db(g, w0, x, y, 1, shards=2, plan_cache_=False)
    one = train_in_db(g, w0, x, y, 1, shards=1, plan_cache_=False)
    assert two.strategy == "sharded"
    for k in ("w_xh", "w_ho"):
        close(two.weights[k], one.weights[k], msg=k)
    import repro_torch.db as db
    for module in ("shard", "zoo", "train_in_db_sharded"):
        assert getattr(db, module) is not None
    assert db.train_in_db_sharded is db.shard.train_in_db_sharded
    assert db.SQLEngine is SQLEngine and db.train_in_db is train_in_db


# ---------------------------------------------------------------------------
# in-database inference (Listing 8) and the closed loop
# ---------------------------------------------------------------------------

def test_infer_and_predict_in_db():
    g, jg, w0, x, y, _ = mlp()
    tw0 = {k: torch.from_numpy(v) for k, v in w0.items()}
    probs = infer_in_db(g, tw0, torch.from_numpy(x))
    close(probs, jtrain.infer_in_db(jg, w0, x), atol=EXACT)
    close(probs, jnn.infer(jg, JEngine("dense"))(
        {k: jnp.asarray(v) for k, v in w0.items()}, jnp.asarray(x)))
    labels = predict_in_db(g, tw0, x)
    np.testing.assert_array_equal(labels, jtrain.predict_in_db(jg, w0, x))
    np.testing.assert_array_equal(labels, np.argmax(probs, axis=1))


def test_trained_model_inference_in_db():
    """Train in the database, infer in the database, against the port's
    dense engine trained from the same start."""
    g, _, w0, x, y, labels = mlp(n_rows=30, lr=0.3)
    res = train_in_db(g, w0, x, y, 25)
    acc_db = float(np.mean(predict_in_db(g, res.weights, x) == labels))
    dense = Engine("dense", device="cpu")
    final, _ = nn2sql.train(g, {k: torch.from_numpy(v) for k, v in w0.items()},
                            torch.from_numpy(x), torch.from_numpy(y), 25,
                            dense)
    probs = nn2sql.infer(g, dense)(final, torch.from_numpy(x))
    acc = float(nn2sql.accuracy(probs, torch.from_numpy(labels)))
    assert abs(acc_db - acc) < 1e-6
    sql_probs = nn2sql.infer(g, Engine("sql", device="cpu"))(res.weights, x)
    assert abs(float(nn2sql.accuracy(sql_probs, labels)) - acc_db) < 1e-6


def test_evaluate_batched_equals_repro():
    """The multi-tenant form: B requests in one query, shared weights."""
    g, jg, w0, x, _, _ = mlp(n_rows=3, n_hidden=4)
    stack = np.random.RandomState(2).rand(5, 3, 4)
    eng = SQLEngine(plan_cache_=False)
    jeng = JSQLEngine(plan_cache_=False)
    out, = eng.evaluate_batched([g.a_ho], dict(w0),
                                {"img": torch.from_numpy(stack)})
    jout, = jeng.evaluate_batched([jg.a_ho], dict(w0), {"img": stack})
    close(out, jout, atol=EXACT)
    single, = eng.evaluate([g.a_ho], {**w0, "img": stack[2]})
    close(out[2], single, atol=EXACT)
    eng.close()
    jeng.close()


def test_explain_and_stats():
    g, _, w0, x, y, _ = mlp()
    eng = SQLEngine()
    env = {**w0, "img": x, "one_hot": y}
    eng.evaluate([g.loss], env)
    eng.evaluate([g.loss], env)
    assert "SCAN" in eng.explain([g.loss]).upper()
    st = eng.stats
    assert st["cache_hits"] >= 1 and st["queries"] > 0
    assert st["ingest_bytes"] == st["adapter"]["ingest_bytes"] > 0
    assert st["adapter"]["ingest_cells"] == sum(v.size for v in env.values())
    merged = SQLEngine.merged_stats([eng])
    assert merged["shards"] == 1 and merged["queries"] == st["queries"]
    eng.close()


@pytest.mark.parametrize("rep", REPS)
def test_evaluate_rows_equals_repro(rep):
    """The raw tagged rows, undecoded: what the same query returns from
    the same sqlite for both packages."""
    g, jg, w0, x, y, _ = mlp(n_rows=4, n_hidden=3)
    env = {**w0, "img": x, "one_hot": y}
    with SQLEngine(plan_cache_=False, **REPS[rep]) as eng, \
            JSQLEngine(plan_cache_=False, **REPS[rep]) as jeng:
        rows = eng.evaluate_rows([g.a_ho, g.loss], env)
        jrows = jeng.evaluate_rows([jg.a_ho, jg.loss], env)
    assert sorted(rows) == sorted(jrows) and len(rows) > 0
