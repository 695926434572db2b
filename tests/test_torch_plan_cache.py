"""The port's persistent rendered-SQL plan cache
(``repro_torch.db.plan_cache``) beside the JAX package's.

What is shared and what is not: ``dag_signature`` (without extras) is the
same in both packages, but every plan key folds in the renderer
fingerprint, a hash of the *source* of ``sqlgen``, ``autodiff`` and
``dialect`` — so the port's keys differ from ``repro``'s, and its default
store is ``~/.cache/repro_torch/plan_cache.db``: the two packages never
serve each other a plan.  Both read ``REPRO_PLAN_CACHE`` (which
``tests/conftest.py`` points at a per-session temporary store).

Results served through a warm cache match JAX's ``Engine("dense")`` within
``TOL = 1e-4`` (the reference's bound, ``tests/test_plan_cache.py``) and
equal the cold results exactly.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Engine as JEngine
from repro.core import nn2sql as jnn
from repro.core.autodiff import gradients as jgradients
from repro.db import plan_cache as jpc
from repro_torch.core import nn2sql, sqlgen
from repro_torch.core import expr as E
from repro_torch.core.autodiff import gradients
from repro_torch.db import plan_cache as pc_mod
from repro_torch.db.plan_cache import PlanCache, default_path
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.db.train import train_in_db

TOL = 1e-4
SPEC = dict(n_rows=8, n_features=4, n_hidden=3, n_classes=2, lr=0.05)


def grad_roots(nn=nn2sql, grad=gradients):
    g = nn.build_graph(nn.MLPSpec(**SPEC))
    grads = grad(g.loss, [g.w_xh, g.w_ho])
    return g, [g.loss, grads[g.w_xh], grads[g.w_ho]]


def env_of(g, seed=3):
    rng = np.random.RandomState(seed)
    w0 = {k: np.array(v) for k, v in
          jnn.init_weights(jnn.MLPSpec(**SPEC)).items()}
    x = rng.rand(g.spec.n_rows, g.spec.n_features).astype(np.float32)
    y = np.eye(g.spec.n_classes, dtype=np.float32)[
        rng.randint(0, g.spec.n_classes, g.spec.n_rows)]
    return {**w0, "img": x, "one_hot": y}


def fresh_structural_twin():
    """Structurally identical DAG built from scratch (new counter state)."""
    for _ in range(7):
        E.const(0.0, (1, 1))
    img, one_hot = E.var("img", (8, 4)), E.var("one_hot", (8, 2))
    w_xh, w_ho = E.var("w_xh", (4, 3)), E.var("w_ho", (3, 2))
    a_xh = E.sigmoid(E.matmul(img, w_xh, name="z_xh"), name="a_xh")
    a_ho = E.sigmoid(E.matmul(a_xh, w_ho, name="z_ho"), name="a_ho")
    loss = E.square(E.sub(a_ho, one_hot, name="diff"), name="loss")
    grads = gradients(loss, [w_xh, w_ho])
    return [loss, grads[w_xh], grads[w_ho]]


def test_keys_differ_from_the_reference_but_signatures_agree():
    _, roots = grad_roots()
    _, jroots = grad_roots(jnn, jgradients)
    assert sqlgen.dag_signature(roots) == jpc.sqlgen.dag_signature(jroots)
    assert pc_mod.renderer_fingerprint() != jpc.renderer_fingerprint()
    assert pc_mod.plan_key(roots, ("sqlite",)) \
        != jpc.plan_key(jroots, ("sqlite",))


def test_default_store_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    assert default_path().endswith(
        os.path.join(".cache", "repro_torch", "plan_cache.db"))
    assert default_path() != jpc.default_path()
    monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
    assert default_path() is None
    monkeypatch.setenv("REPRO_PLAN_CACHE", "/tmp/x.db")
    assert default_path() == "/tmp/x.db"


def test_structural_twins_share_signature_and_sql():
    _, roots = grad_roots()
    twins = fresh_structural_twin()
    assert sqlgen.dag_signature(roots) == sqlgen.dag_signature(twins)
    render = lambda r: sqlgen.to_sql92(r, select=sqlgen.multi_root_select(r),
                                       dialect="sqlite")
    assert render(roots) == render(twins)


def test_memory_and_persistent_store(tmp_path):
    pc = PlanCache(path=None)
    assert pc.get("k") is None
    pc.put("k", "select 1;")
    assert pc.get("k") == "select 1;" and len(pc) == 1
    assert pc.stats["hits"] == 1 and pc.stats["misses"] == 1
    p = str(tmp_path / "plans.db")
    pc1 = PlanCache(path=p)
    pc1.put("k", "select 42;", dialect="sqlite")
    pc1.close()
    pc2 = PlanCache(path=p)
    assert pc2.get("k") == "select 42;" and pc2.stats["entries"] == 1
    pc2.close()


def test_renderer_fingerprint_part_of_key(monkeypatch):
    _, roots = grad_roots()
    k1 = pc_mod.plan_key(roots, extra=("sqlite",))
    monkeypatch.setattr(pc_mod, "_FINGERPRINT", "0123456789abcdef")
    assert pc_mod.plan_key(roots, extra=("sqlite",)) != k1


def test_lru_cap_keeps_hot_keys(tmp_path):
    pc = PlanCache(path=str(tmp_path / "cap.db"), cap=4)
    for k in range(10):
        pc.put(f"k{k}", f"select {k}")
        assert pc.get("k0") == "select 0"      # kept hot
    assert len(pc) <= 4 and pc.get("k0") == "select 0"
    assert pc.stats["evictions"] > 0
    pc.close()


def test_warm_and_cross_session_plans_match_jax_dense(tmp_path):
    g, roots = grad_roots()
    _, jroots = grad_roots(jnn, jgradients)
    env = env_of(g)
    ref = [np.asarray(o) for o in JEngine("dense").eval_fn(jroots)(
        {k: jnp.asarray(v) for k, v in env.items()})]
    pc = PlanCache(path=str(tmp_path / "plans.db"))
    cold = SQLEngine(plan_cache_=pc).evaluate(roots, env)
    assert pc.misses >= 1
    before = pc.misses
    warm = SQLEngine(plan_cache_=pc).evaluate(fresh_structural_twin(), env)
    assert pc.misses == before and pc.hits >= 1
    for a, b, r in zip(cold, warm, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, r, atol=TOL, rtol=0)
    off = SQLEngine(plan_cache_=False)
    assert off.plans is None
    for a, b in zip(off.evaluate(roots, env), cold):
        np.testing.assert_array_equal(a, b)


def test_unchanged_leaves_not_rewritten():
    g, roots = grad_roots()
    env = env_of(g)
    eng = SQLEngine(plan_cache_=PlanCache(path=None))
    fn = eng.eval_fn(roots)
    fn(env)
    writes = []
    orig = eng.adapter.insert_columns
    eng.adapter.insert_columns = (
        lambda name, cols: (writes.append(name), orig(name, cols)))
    orig_upd = eng.adapter.update_cells
    eng.adapter.update_cells = (
        lambda name, *a, **k: (writes.append(name), orig_upd(name, *a, **k)))
    fn(env)
    assert writes == []
    fn(dict(env, w_xh=env["w_xh"] + 1.0))
    assert writes == ["w_xh"]


def test_train_in_db_rendering_cached(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "train_plans.db"))
    monkeypatch.setattr(pc_mod, "_default", None)
    g, _ = grad_roots()
    env = env_of(g)
    w0 = {k: env[k] for k in ("w_xh", "w_ho")}
    r1 = train_in_db(g, w0, env["img"], env["one_hot"], 2)
    cache = pc_mod.default_cache()
    assert cache.path == str(tmp_path / "train_plans.db")
    miss0 = cache.misses
    r2 = train_in_db(g, w0, env["img"], env["one_hot"], 2)
    assert cache.misses == miss0 and cache.hits >= 1 and r1.sql == r2.sql
    for k in w0:
        np.testing.assert_array_equal(r1.weights[k], r2.weights[k])
    h0, m0 = cache.hits, cache.misses
    train_in_db(g, w0, env["img"], env["one_hot"], 1, plan_cache_=False)
    assert (cache.hits, cache.misses) == (h0, m0)
    monkeypatch.setattr(pc_mod, "_default", None)


def test_dag_sql_caches_render(tmp_path):
    pc = PlanCache(path=str(tmp_path / "plans.db"))
    _, roots = grad_roots()
    d = SQLEngine(plan_cache_=False).dialect
    s1 = pc.dag_sql(roots, d, tail="multi_root")
    assert pc.dag_sql(roots, d, tail="multi_root") == s1
    assert pc.hits == 1 and pc.misses == 1
    assert pc.dag_sql(roots, d, tail="last") != s1
    with pytest.raises(ValueError):
        pc.dag_sql(roots, d, tail="sideways")


def test_rendered_single_render_per_key():
    cache = PlanCache(path=None)
    calls = []

    def render():
        calls.append(1)
        return "select 42"

    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        assert cache.rendered("the-key", "sqlite", render) == "select 42"

    ts = [threading.Thread(target=work) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert len(calls) == 1 and cache.hits == 3 and cache.misses == 1
