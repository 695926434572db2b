"""The port's benchmark-metric gate (``repro_torch.obs.regress``) against
the JAX package's: the non-CLI flows of ``tests/test_regress.py``.

``metrics_from_report`` of every committed ``BENCH_*.json`` report, with
its embedded block and with the block removed (the legacy derivation),
equals the reference's; ``compare`` gives the same deltas and
``delta_table`` the same text on the same inputs.
"""
import dataclasses
import json
import pathlib

import pytest

from repro.obs import regress as jregress
from repro_torch import obs
from repro_torch.obs import regress

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPORTS = sorted(p.name for p in ROOT.glob("BENCH_*.json")
                 if not p.name.endswith(".trace.json"))


def _report(mod, **metrics):
    return {"metrics": {k: mod.metric(*v) if isinstance(v, tuple)
                        else mod.metric(v) for k, v in metrics.items()}}


def both(**metrics):
    return _report(regress, **metrics), _report(jregress, **metrics)


def same_deltas(deltas, jdeltas):
    assert [dataclasses.asdict(d) for d in deltas] == [
        dataclasses.asdict(d) for d in jdeltas]
    assert [d.failed for d in deltas] == [d.failed for d in jdeltas]


def test_metric_constructor_equals_the_reference():
    assert regress.metric(1.5) == jregress.metric(1.5) == {
        "value": 1.5, "unit": "s", "direction": "lower"}
    m = regress.metric(4.0, "x", "higher", tolerance=2.0)
    assert m == jregress.metric(4.0, "x", "higher", tolerance=2.0)
    assert m["direction"] == "higher" and m["tolerance"] == 2.0
    assert obs.metric is regress.metric and obs.compare is regress.compare


def test_embedded_block_preferred():
    rep, _ = both(**{"a.t": 1.0})
    rep["forward_grad"] = {"warm_s": 9.9}       # legacy key must be ignored
    assert set(regress.metrics_from_report(rep)) == {"a.t"}
    assert regress.metrics_from_report(rep) == \
        jregress.metrics_from_report(rep)


def test_every_committed_report_is_found():
    assert len(REPORTS) >= 7, REPORTS


@pytest.mark.parametrize("name", REPORTS)
def test_committed_reports_equal_the_reference(name):
    rep = json.loads((ROOT / name).read_text())
    got = regress.metrics_from_report(rep)
    assert got == jregress.metrics_from_report(rep)
    assert got, f"no metrics extracted from {name}"
    for m in got.values():
        assert m["direction"] in ("lower", "higher")
        assert isinstance(m["value"], (int, float))
    legacy = {k: v for k, v in rep.items() if k != "metrics"}
    assert regress.metrics_from_report(legacy) == \
        jregress.metrics_from_report(legacy)
    same_deltas(regress.compare(rep, rep), jregress.compare(rep, rep))
    assert all(d.status == "ok" for d in regress.compare(rep, rep))


def test_legacy_mnist_extraction_backend_prefixed_keys():
    rep = {
        "config": {"backend": "sqlite"},
        "ingestion": {"speedup": 3.0},
        "forward_grad": {"sqlite_warm_s": 0.2, "sqlite_cold_s": 0.5,
                         "fused_speedup": 1.4},
        "training": {"recursive_per_iter_s": 0.1},
        "trace": {"train_iteration": {"attribution": 0.97}},
        "results": [{"workload": "mlp", "relational_s": 2.0,
                     "array_s": 0.5, "speedup_array": 4.0}, {}],
        "moe": {"layer_sql_s": 1.0}, "rwkv": {"time_mix_sql_s": 2.0},
        "ssd": {"relational_s": 3.0, "array_s": float("nan")},
        "lru": {"grads_s": 4.0},
    }
    got = regress.metrics_from_report(rep)
    assert got == jregress.metrics_from_report(rep)
    assert got["forward_grad.warm_s"]["value"] == 0.2
    assert got["forward_grad.cold_s"]["value"] == 0.5
    assert got["trace.train_attribution"]["direction"] == "higher"
    assert got["mlp.speedup_array"]["direction"] == "higher"
    assert "ssd.array_s" not in got           # NaN is dropped


@pytest.mark.parametrize("base,fresh,kw", [
    ({"a.t": 1.0, "b.speedup": (4.0, "x", "higher")},
     {"a.t": 1.0, "b.speedup": (4.0, "x", "higher")}, {}),
    ({"train.s": 1.0}, {"train.s": 2.0}, {}),
    ({"train.s": 1.0}, {"train.s": 1.4}, {}),
    ({"train.s": 1.0}, {"train.s": 0.1}, {}),
    ({"fused.speedup": (3.0, "x", "higher")},
     {"fused.speedup": (1.0, "x", "higher")}, {}),
    ({"fused.speedup": (3.0, "x", "higher")},
     {"fused.speedup": (1.0, "x", "higher")},
     {"gate_directions": ("lower",)}),
    ({"noisy.s": (1.0, "s", "lower", 3.0)},
     {"noisy.s": (2.5, "s", "lower", 3.0)}, {"tolerance": 1.5}),
    ({"gone.s": 1.0, "kept.s": 1.0}, {"kept.s": 1.0, "added.s": 2.0}, {}),
    ({"gone.s": 1.0, "kept.s": 1.0}, {"kept.s": 1.0, "added.s": 2.0},
     {"fail_on_missing": False}),
    ({"zero.s": 0.0}, {"zero.s": 1.0}, {}),
])
def test_compare_equals_the_reference(base, fresh, kw):
    b, jb = both(**base)
    f, jf = both(**fresh)
    deltas = regress.compare(b, f, **kw)
    same_deltas(deltas, jregress.compare(jb, jf, **kw))
    assert regress.delta_table(deltas, title="t") == jregress.delta_table(
        jregress.compare(jb, jf, **kw), title="t")


def test_compare_semantics():
    b, _ = both(**{"train.s": 1.0})
    d, = regress.compare(b, both(**{"train.s": 2.0})[0])
    assert d.status == "regressed" and d.failed
    assert d.ratio == pytest.approx(2.0)
    d, = regress.compare(b, both(**{"train.s": 1.4})[0])
    assert d.status == "ok" and not d.failed
    by = {d.name: d for d in regress.compare(
        both(**{"gone.s": 1.0})[0], both(**{"added.s": 2.0})[0])}
    assert by["gone.s"].status == "missing" and by["gone.s"].failed
    assert by["added.s"].status == "new"


def test_delta_table_renders_every_row():
    b, _ = both(**{"a.s": 1.0, "b.s": 1.0})
    f, _ = both(**{"a.s": 1.0, "b.s": 5.0})
    text = regress.delta_table(regress.compare(b, f), title="t")
    assert text.splitlines()[0] == "t"
    assert "a.s" in text and "b.s" in text and "regressed" in text
    assert "5.00x" in text and "1 regressed (b.s)" in text
