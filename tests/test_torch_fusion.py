"""Twin of ``tests/test_fusion.py``'s executed differential for the port:
for every dialect the environment can run, the port's fused (and, under
substitution CTE semantics, spooled) plan computes the same values as its
unfused rendering within the reference's 1e-4 — over seeded random
elementwise-heavy DAGs with fan-out and over the MLP forward/backward
graph — and the fused values equal the JAX package's fused plan's on the
same DAG, within the same bound.  (``tests/test_torch_sqlgen.py`` holds
the fused renderings against the goldens.)
"""
import numpy as np
import pytest

from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro.core.autodiff import gradients as jgradients
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro_torch.core import expr as E
from repro_torch.core import nn2sql
from repro_torch.core.autodiff import gradients
from repro_torch.db import HAVE_DUCKDB
from repro_torch.db.sql_engine import SQLEngine

TOL = 1e-4

#: dialect → engine kwargs; sql92 renders generate_series so it needs the
#: duckdb engine; sqlite and array always run
ENGINES = {
    "sqlite": dict(backend="sqlite"),
    "array": dict(backend="sqlite", dialect="array"),
    "duckdb": dict(backend="duckdb"),
    "sql92": dict(backend="duckdb", dialect="sql92"),
}
DIALECTS = sorted(ENGINES)


def random_elementwise_dag(E, seed, n_ops=9):
    """A seeded DAG mixing matmuls with elementwise chains; drawing
    operands from the whole pool produces genuine fan-out (nodes with
    several consumers) so absorption limits are exercised.  ``E`` is
    either package's ``core.expr``: one seed builds the same DAG in
    both."""
    rng = np.random.RandomState(seed)
    x = E.var("fx", (5, 4))
    w = E.var("fw", (4, 4))
    pool = [E.matmul(x, w)]
    unary = [E.sigmoid, E.relu, E.square,
             lambda a: E.scale(float(rng.uniform(-2, 2)), a)]
    binary = [E.add, E.sub, E.hadamard]
    for _ in range(n_ops):
        if rng.rand() < 0.55:
            pool.append(unary[rng.randint(len(unary))](
                pool[rng.randint(len(pool))]))
        else:
            a = pool[rng.randint(len(pool))]
            b = pool[rng.randint(len(pool))]
            pool.append(binary[rng.randint(len(binary))](a, b))
    # two roots so multi-root fan-out counting is exercised as well
    return [pool[-1], pool[rng.randint(len(pool))]], {
        "fx": rng.randn(5, 4), "fw": rng.randn(4, 4)}


def mlp_roots(nn2sql, gradients):
    g = nn2sql.build_graph(nn2sql.MLPSpec(6, 5, 4, 3, lr=0.05))
    grads = gradients(g.loss, [g.w_xh, g.w_ho])
    rng = np.random.RandomState(7)
    env = {"img": rng.rand(6, 5), "one_hot": np.eye(3)[rng.randint(0, 3, 6)],
           "w_xh": rng.randn(5, 4) * 0.3, "w_ho": rng.randn(4, 3) * 0.3}
    return [g.loss, grads[g.w_xh], grads[g.w_ho]], env


def _evaluate(engine_cls, dialect, roots, env, **kw):
    if ENGINES[dialect].get("backend") == "duckdb" and not HAVE_DUCKDB:
        pytest.skip("duckdb not importable")
    eng = engine_cls(plan_cache_=False, **ENGINES[dialect], **kw)
    try:
        return eng.evaluate(roots, env)
    finally:
        eng.close()


class TestDifferential:
    @pytest.mark.parametrize("dialect", DIALECTS)
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_dags_fused_matches_unfused(self, dialect, seed):
        roots, env = random_elementwise_dag(E, seed)
        base = _evaluate(SQLEngine, dialect, roots, env, fuse=False,
                         spool=False)
        fused = _evaluate(SQLEngine, dialect, roots, env, fuse=True,
                          spool=False)
        both = _evaluate(SQLEngine, dialect, roots, env, fuse=True,
                         spool=True)
        jroots, jenv = random_elementwise_dag(JE, seed)
        want = _evaluate(JSQLEngine, dialect, jroots, jenv, fuse=True,
                         spool=True)
        for b, f, s, w in zip(base, fused, both, want, strict=True):
            np.testing.assert_allclose(f, b, atol=TOL)
            np.testing.assert_allclose(s, b, atol=TOL)
            np.testing.assert_allclose(s, w, atol=TOL)

    @pytest.mark.parametrize("dialect", DIALECTS)
    def test_mlp_forward_backward_fused_matches_unfused(self, dialect):
        roots, env = mlp_roots(nn2sql, gradients)
        base = _evaluate(SQLEngine, dialect, roots, env, fuse=False,
                         spool=False)
        fused = _evaluate(SQLEngine, dialect, roots, env, fuse=True,
                          spool=True)
        jroots, _ = mlp_roots(jnn, jgradients)
        want = _evaluate(JSQLEngine, dialect, jroots, env, fuse=True,
                         spool=True)
        for b, f, w in zip(base, fused, want, strict=True):
            np.testing.assert_allclose(f, b, atol=TOL)
            np.testing.assert_allclose(f, w, atol=TOL)
