"""Twin of ``tests/test_scan_composition.py`` for the port: scans must
COMPOSE on substitution-semantics engines (sqlite).

sqlite flattens non-recursive CTE references by substitution, so a
recursive member that references the scan-input CTE re-executes it at
every step — and a scan whose input is *itself* a scan would splice one
recursion into another's recursive member.  ``_render_refs`` counts a
``Recurrence``'s input twice, so the spool pass materialises the scan
input as an engine-side temp table before the main statement.  These
tests pin both halves on the port's ``sqlgen`` and ``SQLEngine`` — the
plan shape (equal to the JAX package's plan) and the executed numbers
(against the dense scan, 1e-12, as the reference holds them, and against
the JAX package's engine on the same DAG).
"""
from __future__ import annotations

import numpy as np

from repro.core import expr as JE
from repro.core import sqlgen as jsqlgen
from repro.db.dialect import get_dialect as jget_dialect
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro_torch.core import expr as E
from repro_torch.core import sqlgen
from repro_torch.db.dialect import get_dialect
from repro_torch.db.sql_engine import SQLEngine

ATOL = 1e-12


def _scan(av, bv):
    """Dense reference: s_t = a_t ∘ s_{t-1} + b_t, s_0 = 0."""
    s = np.zeros(av.shape[1])
    out = []
    for t in range(av.shape[0]):
        s = av[t] * s + bv[t]
        out.append(s.copy())
    return np.asarray(out)


def _vars(E, shape):
    return [E.var(n, shape) for n in "abc"]


def _nested(E, T=6, C=4, seed=3):
    rng = np.random.RandomState(seed)
    a, b, c = _vars(E, (T, C))
    inner = E.recurrence(a, b, name="inner")
    # the inner scan in the COEFFICIENT slot — the composition that used
    # to be substituted into the outer recursive member
    outer = E.recurrence(inner, c, name="outer")
    env = {"a": rng.randn(T, C) * 0.5, "b": rng.randn(T, C),
           "c": rng.randn(T, C) * 0.5}
    return outer, env, _scan(_scan(env["a"], env["b"]), env["c"])


def _evaluate_both(root, jroot, env):
    """The DAG on the port's engine and the JAX package's, both sqlite."""
    with SQLEngine(plan_cache_=False) as eng:
        assert eng.spool  # sqlite: substitution semantics
        got, = eng.evaluate([root], env)
    with JSQLEngine(plan_cache_=False) as jeng:
        want, = jeng.evaluate([jroot], env)
    return got, want


def test_scan_input_is_spooled_on_substitution_dialects():
    outer, _, _ = _nested(E)
    plan = sqlgen.render_plan([outer], dialect=get_dialect("sqlite"),
                              spool=True, spool_threshold=2)
    assert [t for t, _ in plan.steps] == ["_sp_inner"]
    assert "_sp_inner" in plan.sql
    jouter, _, _ = _nested(JE)
    jplan = jsqlgen.render_plan([jouter], dialect=jget_dialect("sqlite"),
                                spool=True, spool_threshold=2)
    assert plan.to_text() == jplan.to_text()


def test_nested_scan_executes_exactly_on_sqlite():
    outer, env, ref = _nested(E)
    jouter, _, _ = _nested(JE)
    got, want = _evaluate_both(outer, jouter, env)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _seeded(E, T=5, C=3):
    a, b, c = _vars(E, (T, C))
    inner = E.recurrence(a, b, name="inner2")
    return E.recurrence(c, inner, name="outer2")  # inner seeds b_t


def test_nested_scan_in_seed_slot_executes_exactly():
    T, C = 5, 3
    rng = np.random.RandomState(9)
    env = {"a": rng.randn(T, C) * 0.5, "b": rng.randn(T, C),
           "c": rng.randn(T, C) * 0.5}
    ref = _scan(env["c"], _scan(env["a"], env["b"]))
    got, want = _evaluate_both(_seeded(E, T, C), _seeded(JE, T, C), env)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _fan(E, T=5, C=3):
    a, b = E.var("a", (T, C)), E.var("b", (T, C))
    s = E.recurrence(a, b, name="fan")
    return E.add(s, E.hadamard(s, s))


def test_scan_reused_downstream_still_exact():
    """The doubled multiplicity must not break single-scan DAGs where the
    scan output itself fans out (spooled as before)."""
    T, C = 5, 3
    rng = np.random.RandomState(4)
    env = {"a": rng.randn(T, C) * 0.5, "b": rng.randn(T, C)}
    sv = _scan(env["a"], env["b"])
    got, want = _evaluate_both(_fan(E, T, C), _fan(JE, T, C), env)
    np.testing.assert_allclose(got, sv + sv * sv, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)
