"""The port's SQL transpiler (``repro_torch.core.sqlgen``) against the JAX
package's: every golden snapshot in ``tests/golden/*.sql`` rendered from the
port's IR byte for byte, ``dag_signature`` equal in both packages, and the
Listing 4/7/10 structure tests of ``tests/test_sqlgen.py`` on the port.

Tolerance: none.  Rendering is string work over the same DAG structure, so
the port's text must equal the reference's exactly.
"""
import pathlib
from types import SimpleNamespace

import pytest

from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro.core import sqlgen as jsql
from repro.core.autodiff import gradients as jgradients
from repro_torch.core import expr as E
from repro_torch.core import nn2sql, sqlgen
from repro_torch.core.autodiff import gradients

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"

JAX = SimpleNamespace(E=JE, nn2sql=jnn, sqlgen=jsql, gradients=jgradients)
PORT = SimpleNamespace(E=E, nn2sql=nn2sql, sqlgen=sqlgen,
                       gradients=gradients)


def _spec(pkg):
    return pkg.nn2sql.MLPSpec(n_rows=4, n_features=4, n_hidden=3,
                              n_classes=2, lr=0.05)


def _graph(pkg):
    return pkg.nn2sql.build_graph(_spec(pkg))


def _grad_roots(pkg):
    g = _graph(pkg)
    grads = pkg.gradients(g.loss, [g.w_xh, g.w_ho])
    return [g.loss, grads[g.w_xh], grads[g.w_ho]]


def _zoo_roots(pkg, prim):
    E_ = pkg.E
    zx, zidx = E_.var("zx", (4, 3)), E_.var("zidx", (4, 1))
    za, zb = E_.var("za", (4, 3)), E_.var("zb", (4, 3))
    return {
        "rowreduce": lambda: [E_.row_reduce(zx, "sum", 1),
                              E_.row_reduce(zx, "max", 0)],
        "softmax": lambda: [E_.softmax(zx)],
        "topk": lambda: [E_.argtopk(zx, 2)],
        "gather": lambda: [E_.gather(zx, zidx)],
        "scatter": lambda: [E_.scatter(zx, zidx, 5)],
        "rowshift": lambda: [E_.row_shift(zx, 1), E_.row_shift(zx, -1)],
        "recurrence": lambda: [E_.recurrence(za, zb),
                               E_.recurrence(za, zb, reverse=True)],
    }[prim]()


ZOO = ("rowreduce", "softmax", "topk", "gather", "scatter", "rowshift",
       "recurrence")


def roots_of(pkg, name):
    """The DAG each golden case renders (``None`` for the training
    queries, which render from the graph)."""
    stem = name.split(".")[0]
    if stem == "listing5_const":
        return [pkg.E.const(1.0, (3, 2))]
    if stem in ("listing6_forward", "listing10_forward_arrays"):
        return [_graph(pkg).a_ho]
    if stem == "gradients_multiroot":
        return _grad_roots(pkg)
    if stem.startswith("zoo_"):
        return _zoo_roots(pkg, stem[4:])
    return None


def render(pkg, name):
    """The rendering of ``tests/test_sqlgen_golden.py``'s case ``name``."""
    sg, lr = pkg.sqlgen, _spec(pkg).lr
    stem, _, rest = name.partition(".")
    dia = rest.split(".")[0]
    roots = roots_of(pkg, name)
    if stem == "listing5_const" or (stem == "listing6_forward"
                                    and dia != "array"):
        return sg.to_sql92(roots, dialect=dia)
    if stem == "listing6_forward":
        return sg.to_sql(roots, dialect="array")
    if stem == "listing7_training":
        return sg.training_query_sql92(_graph(pkg), 10, lr, dia)
    if stem == "listing7_step":
        return sg.training_step_sql92(_graph(pkg), lr, dia)
    if stem == "listing10_training_arrays":
        return sg.training_query_arrays(_graph(pkg), 10, lr)
    if stem == "listing10_training_array_calls":
        return sg.training_query_array_calls(_graph(pkg), 10, lr)
    if stem == "listing10_forward_arrays":
        return sg.to_sql_arrays(roots)
    if stem == "listing10_training":
        return sg.training_query(_graph(pkg), 10, lr, "array")
    tail = sg.multi_root_tail(roots, dia)
    if rest.endswith("plan.fused"):
        return sg.render_plan(roots, select=tail, dialect=dia, fuse=True,
                              spool=True).to_text()
    return sg.to_sql(roots, select=tail, dialect=dia,
                     fuse=rest.endswith("fused"))


GOLDEN = sorted(p.name[:-len(".sql")] for p in GOLDEN_DIR.glob("*.sql"))


def test_every_golden_file_has_a_case():
    assert len(GOLDEN) == 50
    assert {n.split(".")[0] for n in GOLDEN if n.startswith("zoo_")} \
        == {f"zoo_{p}" for p in ZOO}


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_rendered_byte_identically(name):
    want = (GOLDEN_DIR / f"{name}.sql").read_text().rstrip("\n")
    got = render(PORT, name)
    assert got == render(JAX, name)
    assert got == want


@pytest.mark.parametrize("name", sorted(
    {n for n in GOLDEN if roots_of(PORT, n) is not None}))
def test_dag_signature_is_the_same_in_both_packages(name):
    extra = ("sqlite", "tail:multi_root")
    for ex in ((), extra):
        assert sqlgen.dag_signature(roots_of(PORT, name), extra=ex) \
            == jsql.dag_signature(roots_of(JAX, name), extra=ex)


def test_dag_signature_separates_zoo_attributes():
    zx = E.var("zx", (4, 3))
    sigs = {sqlgen.dag_signature([r]) for r in (
        E.row_reduce(zx, "sum", 1), E.row_reduce(zx, "max", 1),
        E.row_reduce(zx, "sum", 0), E.argtopk(zx, 1), E.argtopk(zx, 2),
        E.row_shift(zx, 1), E.row_shift(zx, -1))}
    assert len(sigs) == 7


def test_rendering_is_counter_independent():
    before = {n: render(PORT, n) for n in GOLDEN}
    nn2sql.build_graph.cache_clear()
    for _ in range(11):
        E.const(0.0, (1, 1))
    assert {n: render(PORT, n) for n in GOLDEN} == before


# -- twins of tests/test_sqlgen.py: Listing 4/7/10 structure ----------------

def _mlp(pkg):
    return pkg.nn2sql.build_graph(pkg.nn2sql.MLPSpec(150, 4, 20, 3))


def test_matmul_is_join_groupby():
    sql = sqlgen.to_sql92([E.matmul(E.var("m", (3, 4)), E.var("n", (4, 5)),
                                    name="mm")])
    assert sql == jsql.to_sql92([JE.matmul(JE.var("m", (3, 4)),
                                           JE.var("n", (4, 5)), name="mm")])
    assert "sum(m.v*n.v)" in sql
    assert "inner join n as n on m.j = n.i" in sql
    assert "group by m.i, n.j" in sql


def test_elementwise_building_blocks():
    m, n = E.var("m", (3, 4)), E.var("n", (3, 4))
    assert "on m.i = n.i and m.j = n.j" in sqlgen.to_sql92(
        [E.hadamard(m, n, name="h")])
    assert "1/(1+exp(-v))" in sqlgen.to_sql92(
        [E.sigmoid(E.var("m", (2, 2)), name="s")])
    assert "select j as i, i as j, v from m" in sqlgen.to_sql92(
        [E.transpose(E.var("m", (2, 3)), name="t")])


def test_listing7_training_query_structure():
    sql = sqlgen.training_query_sql92(_mlp(PORT), n_iters=20, lr=0.01)
    assert sql == jsql.training_query_sql92(_mlp(JAX), n_iters=20, lr=0.01)
    assert sql.startswith("with recursive w (iter, id, i, j, v) as (")
    assert "select 0, 0, * from w_xh_init union all" in sql
    assert "select 0, 1, * from w_ho_init" in sql
    assert sql.count("from w\n") + sql.count("from w ") == 1
    for cte in ("a_xh", "a_ho", "z_xh", "z_ho"):
        assert f"{cte}(i, j, v) as (" in sql
    assert "w_.v - 0.01 * d_w.v" in sql and "w_.iter < 20" in sql
    assert "v*(1-v)" in sql
    assert sql.count("(") == sql.count(")")
    assert sql.rstrip().endswith("select * from w;")


def test_listing10_array_query_structure():
    sql = sqlgen.training_query_arrays(_mlp(PORT), n_iters=20, lr=0.01)
    assert sql == jsql.training_query_arrays(_mlp(JAX), n_iters=20, lr=0.01)
    assert "with recursive w (id, w_xh, w_ho) as (" in sql
    for part in ("**", "transpose(img)", "sig(", "id < 20",
                 "(a_xh * (1 - a_xh))", "(a_ho * (1 - a_ho))",
                 "transpose(w_ho)"):
        assert part in sql
    assert sql.count("(") == sql.count(")")


def test_forward_inference_query():
    g = _mlp(PORT)
    sql = sqlgen.to_sql92([g.a_ho])
    assert sql == jsql.to_sql92([_mlp(JAX).a_ho])
    assert "from img" in sql and "group by" in sql
    arrays = sqlgen.to_sql_arrays([g.a_ho])
    assert arrays == jsql.to_sql_arrays([_mlp(JAX).a_ho])
    assert "(a_xh ** w_ho)" in arrays and "sig(" in arrays


def test_core_imports_no_db():
    """``import repro_torch.core`` must not import the SQL tier: sqlgen
    resolves its dialects lazily (core ↛ db)."""
    import subprocess
    import sys
    code = ("import sys, repro_torch.core; "
            "print(any(m.startswith('repro_torch.db') for m in sys.modules))")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
