"""The port's report CLI (``python -m repro_torch.obs.report``) against the
JAX package's: the report-CLI flows of ``tests/test_obs.py``.

One traced capture (a value-and-grad step and its per-node profile, the
``trace_spans`` / ``metric_points`` / ``profile_nodes`` relations in a
sqlite file, and the Chrome trace) is made by each package; both
``report.main``s render every capture, and the committed
``BENCH_db_mnist.trace.json``, to the same text.  The one line that names
a module (the hint when a capture holds no profiled run) names each
package's own profiler.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import nn2sql as jnn
from repro.db.adapter import connect as jconnect
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.core import nn2sql
from repro_torch.db.adapter import connect
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.obs import report

ROOT = pathlib.Path(__file__).resolve().parents[1]


def fixture(nn):
    """``tests/test_obs.py``'s ``_train_step_fixture`` over ``nn``."""
    spec = nn.MLPSpec(n_rows=8, n_features=6, n_hidden=5, n_classes=3,
                      lr=0.05)
    graph = nn.build_graph(spec)
    rng = np.random.default_rng(3)
    env = {"w_xh": rng.normal(size=(6, 5)) * 0.3,
           "w_ho": rng.normal(size=(5, 3)) * 0.3,
           "img": rng.normal(size=(8, 6)),
           "one_hot": np.eye(3)[rng.integers(0, 3, size=8)]}
    return graph, env


def capture(tmp_path, port: bool, profile: bool = True):
    """A traced sqlite file and Chrome trace, made by one package."""
    o, nn, eng_cls, conn = ((obs, nn2sql, SQLEngine, connect) if port
                            else (jobs, jnn, JSQLEngine, jconnect))
    tag = "port" if port else "ref"
    graph, env = fixture(nn)
    tr = o.Tracer()
    db_path = str(tmp_path / f"{tag}.db")
    ad = conn("sqlite", db_path)
    with o.use(tr):
        eng = eng_cls(adapter=ad)
        eng.value_and_grad_fn(graph.loss, [graph.w_xh, graph.w_ho])(env)
        res = (eng.profile_value_and_grad(graph.loss,
                                          [graph.w_xh, graph.w_ho], env)
               if profile else None)
    o.write_trace_spans(ad, tr)
    o.write_metric_points(ad, tr)
    if res is not None:
        o.write_profile_nodes(ad, res)
    trace = o.write_chrome_trace(tr, str(tmp_path / f"{tag}.json"))
    ad.close()
    return db_path, trace


def rendered(main, path, capsys, *args):
    assert main([path, *args]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("port", [True, False], ids=["port", "reference"])
@pytest.mark.parametrize("top", [[], ["--top", "5"]])
def test_both_reports_render_the_same_text(tmp_path, capsys, port, top):
    db_path, trace = capture(tmp_path, port)
    for path in (db_path, trace):
        text = rendered(report.main, path, capsys, *top)
        assert text == rendered(jreport.main, path, capsys, *top)
        assert "stage breakdown" in text and "metric percentiles" in text


def test_database_report_sections(tmp_path, capsys):
    db_path, _ = capture(tmp_path, port=True)
    out = rendered(report.main, db_path, capsys, "--top", "5")
    assert "observability report (database)" in out
    assert "db.execute" in out
    assert "hottest IR nodes" in out and "MatMul" in out
    assert "train.loss" in out or "sql.evaluate_ms" in out


def test_chrome_trace_report_sections(tmp_path, capsys):
    _, trace = capture(tmp_path, port=True)
    out = rendered(report.main, trace, capsys)
    assert "observability report (chrome-trace)" in out
    assert "profile" in out or "MatMul" in out
    assert "sql.evaluate_ms" in out


def as_reference(text):
    return text.replace("repro_torch.obs.profiler", "repro.obs.profiler")


def test_committed_trace_renders_the_same(capsys):
    """``BENCH_db_mnist.trace.json`` holds no profiled run."""
    path = str(ROOT / "BENCH_db_mnist.trace.json")
    text = rendered(report.main, path, capsys, "--top", "5")
    assert "repro_torch.obs.profiler" in text
    assert as_reference(text) == rendered(jreport.main, path, capsys,
                                          "--top", "5")
    assert report.load_capture(path) == jreport.load_capture(path)


def test_capture_without_a_profile_names_each_profiler(tmp_path, capsys):
    db_path, trace = capture(tmp_path, port=True, profile=False)
    for path in (db_path, trace):
        text = rendered(report.main, path, capsys)
        ref = rendered(jreport.main, path, capsys)
        assert "see SQLEngine.profile / repro_torch.obs.profiler" in text
        assert as_reference(text) == ref


def test_module_runs_from_the_command_line(tmp_path):
    db_path, _ = capture(tmp_path, port=True)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", db_path, "--top",
         "3"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert "observability report (database)" in run.stdout
