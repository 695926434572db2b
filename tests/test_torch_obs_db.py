"""The port's observability of the in-database tier: the static coverage
scan of ``tests/test_obs_coverage.py`` pointed at ``src/repro_torch``, the
exporters (the Chrome-trace golden, the ``trace_spans`` and
``metric_points`` relations), the engine's span topology, and the per-IR-
node profiler against ``evaluate`` and against the JAX package's profiler.

Tolerance: the profiler's outputs equal ``evaluate``'s within 1e-12 (the
same sqlite, one statement against a chain of temp-table steps, float64
both ways) and the JAX package's profiler within the same bound.
"""
import ast
import json
import pathlib
import re

import numpy as np
import pytest

from repro.core import nn2sql as jnn
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro_torch import obs
from repro_torch.core import expr as E
from repro_torch.core import nn2sql
from repro_torch.db.plan_cache import PlanCache
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.db.train import loss_trajectory_in_db, train_in_db

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"
GOLDEN = ROOT / "tests" / "golden" / "obs_chrome_trace.json"

EXEC_CALL = re.compile(r"conn\.(execute|executemany|cursor)\s*\(")
EXEMPT = re.compile(r"#\s*obs:\s*exempt\s*(—|-)\s*\S")
ADAPTER_FILES = sorted((SRC / "db" / "adapters").glob("*.py")) + [
    SRC / "db" / "adapter.py"]
# obs/report.py reads a finished capture file, not a traced engine: the
# reference's scan (tests/test_obs_coverage.py) allows it too
ALLOWED_RAW = ({"db/adapter.py", "db/plan_cache.py", "obs/report.py"}
               | {f.relative_to(SRC).as_posix() for f in ADAPTER_FILES})


def _functions_with_source(path):
    text = path.read_text()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, ast.get_source_segment(text, node)


def test_adapter_raw_execution_is_span_wrapped_or_exempt():
    offenders = [f"{p.name}:{name}" for p in ADAPTER_FILES
                 for name, src in _functions_with_source(p)
                 if EXEC_CALL.search(src) and "span(" not in src
                 and not EXEMPT.search(src)]
    assert not offenders


def test_adapter_core_paths_are_instrumented_not_exempted():
    wrappers = [(n, s) for p in ADAPTER_FILES
                for n, s in _functions_with_source(p)
                if n in ("execute", "executemany")]
    assert wrappers
    for name, src in wrappers:
        if EXEC_CALL.search(src) or "_raw(" in src:
            assert "span(" in src and not EXEMPT.search(src), name
        else:
            assert f"Adapter.{name}(" in src or "span(" in src, name


def test_raw_connection_confined_to_adapter_and_plan_cache():
    offenders = [f"{p.relative_to(SRC)}:{i}"
                 for p in SRC.rglob("*.py")
                 if p.relative_to(SRC).as_posix() not in ALLOWED_RAW
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if EXEC_CALL.search(line)]
    assert not offenders
    for p in ADAPTER_FILES:
        for line in p.read_text().splitlines():
            if "obs: exempt" in line:
                assert EXEMPT.search(line), line


def small_dag():
    a, b = E.var("a", (3, 4)), E.var("b", (4, 2))
    return E.matmul(a, b, name="c"), {"a": np.arange(12.0).reshape(3, 4),
                                      "b": np.ones((4, 2))}


def test_chrome_trace_golden(tmp_path):
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tr = obs.Tracer(clock=clock)
    with tr.span("sql.evaluate", root="c", dialect="sqlite"):
        with tr.span("sql.ingest"):
            pass
        with tr.span("db.execute", rows=6):
            pass
    tr.inc("queries", 2)
    tr.gauge("recursive_cte_depth", 3)
    text = json.dumps(obs.chrome_trace(tr), indent=1, sort_keys=True) + "\n"
    assert text == GOLDEN.read_text()
    out = obs.write_chrome_trace(tr, str(tmp_path / "t.json"))
    assert json.loads(pathlib.Path(out).read_text()) == json.loads(text)


def test_trace_spans_relation_and_span_topology():
    root, env = small_dag()
    tr = obs.Tracer()
    with SQLEngine(plan_cache_=PlanCache(path=None), tracer=tr) as eng:
        out, = eng.evaluate([root], env)
        np.testing.assert_array_equal(out, env["a"] @ env["b"])
        ev, = [s for s in tr.spans if s.name == "sql.evaluate"]
        assert ev.attrs["root"] == "c" and ev.attrs["rows_returned"] == 6
        assert ev.attrs["representation"] == "relational"
        children = {s.name for s in tr.spans if s.parent_id == ev.span_id}
        assert {"sql.ingest", "sql.render", "sql.explain", "db.execute",
                "sql.decode"} <= children
        bd = obs.stage_breakdown(tr, root="sql.evaluate")
        assert bd["root_count"] == 1 and 0.0 < bd["attribution"] <= 1.0
        n_before = len(tr.spans)
        n = obs.write_trace_spans(eng.adapter, tr)
        assert n == n_before > 0
        assert eng.adapter.execute(
            "select count(*), count(distinct span_id) from trace_spans")[0] \
            == (n, n)
        names = [r[0] for r in eng.adapter.execute(obs.STAGE_SQL)]
        assert "db.execute" in names and "sql.evaluate" not in names
        attrs, = eng.adapter.execute(
            "select attrs from trace_spans where name = 'sql.evaluate'")
        assert json.loads(attrs[0])["dialect"] == "sqlite"


def test_metric_points_relation():
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]

    tr = obs.Tracer(clock=clock)
    tr.point("train.loss", 2.5, step=0)
    tr.point("train.loss", 1.25, step=1, source="test")
    tr.point("serve.tokens_per_s", 100.0)
    with SQLEngine(plan_cache_=False) as eng:
        assert obs.write_metric_points(eng.adapter, tr) == 3
        rows = eng.adapter.execute("select seq, metric, step, value, labels"
                                   " from metric_points order by seq")
        assert [r[1] for r in rows] == ["train.loss", "train.loss",
                                        "serve.tokens_per_s"]
        assert rows[1][2:4] == (1, 1.25) and rows[2][2] is None
        assert json.loads(rows[1][4]) == {"source": "test"}
        by_metric = {r[0]: r for r in eng.adapter.execute(obs.METRIC_SQL)}
        assert by_metric["train.loss"][1] == 2
        assert by_metric["train.loss"][4] == pytest.approx(1.875)
        assert eng.adapter.execute(
            "select t_us from metric_points where seq = 0")[0][0] \
            == pytest.approx(0.5e6)
    assert obs.percentiles_from_values([3, 1, 2, 4]) == {
        "p50": 2.0, "p90": 4.0, "p95": 4.0, "p99": 4.0}
    assert obs.percentiles_from_values([]) == {
        "p50": 0.0, "p90": 0.0, "p95": 0.0, "p99": 0.0}


def test_training_spans_and_time_series():
    spec = nn2sql.MLPSpec(n_rows=4, n_features=4, n_hidden=3, n_classes=2,
                          lr=0.05)
    graph = nn2sql.build_graph(spec)
    rng = np.random.default_rng(0)
    weights = {"w_xh": rng.normal(size=(4, 3)) * 0.1,
               "w_ho": rng.normal(size=(3, 2)) * 0.1}
    x = rng.normal(size=(4, 4))
    y = np.eye(2)[rng.integers(0, 2, size=4)]
    tr = obs.Tracer()
    with obs.use(tr):
        res = train_in_db(graph, weights, x, y, n_iters=2, plan_cache_=False)
        loss_trajectory_in_db(graph, res.history, x, y)
    root, = [s for s in tr.spans if s.name == "train.in_db"]
    assert root.attrs["n_iters"] == 2
    bd = obs.stage_breakdown(tr, root="train.in_db")
    assert {"train.ingest", "sql.render", "db.execute",
            "train.decode"} <= set(bd["stages"])
    assert tr.gauges.get("recursive_cte_depth") == 2
    metrics = {p.metric for p in tr.points}
    assert {"train.iter_ms", "train.cte_bytes", "train.loss"} <= metrics
    losses = [p for p in tr.points if p.metric == "train.loss"]
    assert [p.step for p in losses] == [0, 1, 2]
    assert losses[-1].value <= losses[0].value


def _train_step_fixture(nn):
    spec = nn.MLPSpec(n_rows=8, n_features=6, n_hidden=5, n_classes=3,
                      lr=0.05)
    rng = np.random.default_rng(3)
    env = {"w_xh": rng.normal(size=(6, 5)) * 0.3,
           "w_ho": rng.normal(size=(5, 3)) * 0.3,
           "img": rng.normal(size=(8, 6)),
           "one_hot": np.eye(3)[rng.integers(0, 3, size=8)]}
    return nn.build_graph(spec), env


@pytest.mark.parametrize("dialect", [None, "array"])
def test_profiler_node_table_matches_evaluate_and_the_reference(dialect):
    graph, env = _train_step_fixture(nn2sql)
    jgraph, _ = _train_step_fixture(jnn)
    tr = obs.Tracer()
    with SQLEngine(plan_cache_=False, dialect=dialect, tracer=tr) as eng:
        res = eng.profile_value_and_grad(graph.loss,
                                         [graph.w_xh, graph.w_ho], env)
        loss, grads = eng.value_and_grad_fn(
            graph.loss, [graph.w_xh, graph.w_ho])(env)
        assert obs.write_profile_nodes(eng.adapter, res) == len(res.nodes)
        by_kind = eng.adapter.execute(obs.NODE_SQL)
        assert sum(r[1] for r in by_kind) == len(res.nodes)
    with JSQLEngine(plan_cache_=False, dialect=dialect) as jeng:
        jres = jeng.profile_value_and_grad(jgraph.loss,
                                           [jgraph.w_xh, jgraph.w_ho], env)
    for got, want in zip(res.outputs, [loss, grads["w_xh"], grads["w_ho"]]):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    for got, want in zip(res.outputs, jres.outputs):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert sorted(n.kind for n in res.nodes) \
        == sorted(n.kind for n in jres.nodes)
    assert any(n.kind.startswith("MatMul") for n in res.nodes)
    for n in res.nodes:
        assert n.self_s >= 0.0 and n.rows > 0 and n.bytes > 0
        assert len(n.signature) == 16 and n.sql_head
    assert res.nodes == sorted(res.nodes, key=lambda n: -n.self_s)
    assert set(res.stages) == {"ingest", "render", "tail", "decode",
                               "probe"}
    assert "profile of" in res.report(top=5)
    node_spans = [s for s in tr.spans if s.name == "profile.node"]
    assert len(node_spans) == len(res.nodes)
