"""The readers of the metrics that the program's own spans and counters
give (``portbench/program_spans.py``), each held to a hand-built session
(the program's own ``SessionTracer``, fed spans with stand-in CUDA
events) and a fake ``Observed``: the number it should read, and None where
the session holds no unit span or the program keeps no session."""
import json
import types

import pytest

from portbench import manifest, program_spans
from portbench.tests.conftest import ROOT
from repro_torch.obs import SessionTracer

UNITS = 4


class Event:
    """Stands in for a ``torch.cuda.Event`` pair: the end's ``query`` and
    the start's ``elapsed_time``."""

    def __init__(self, ms=None, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms


def span(name, duration=0.0, device_ms=None, done=True, **attrs):
    events = None if device_ms is None else (Event(),
                                             Event(device_ms, done))
    return types.SimpleNamespace(name=name, duration=duration, attrs=attrs,
                                 _events=events)


MLP = [span("nn2sql.iteration", 0.05, cuda_mallocs=3),
       span("nn2sql.iteration", 0.05, cuda_mallocs=1),
       span("nn2sql.iteration", 0.05, cuda_mallocs=0),
       span("nn2sql.iteration", 0.05, cuda_mallocs=2),
       span("kernels.status_wait", 0.002), span("kernels.status_wait", 0.006),
       span("kernels.launch", 0.001), span("kernels.launch", 0.003),
       span("kernels.relational_matmul", 0.010)]
LM = [span("train.step", 0.5)] * UNITS + [
    span("train.forward", 0.1, 100.0), span("train.forward", 0.1, 60.0),
    span("train.backward", 0.2, 300.0), span("train.backward", 0.2, 140.0),
    span("kernels.status_wait", 0.004), span("kernels.status_wait", 0.008)]
LM_COUNTERS = {"moe.assignments": 4000, "moe.dropped": 1000}

#: metric -> (session's spans, counters, the reading)
CASES = {
    "status_wait_ms.mlp": (MLP, {}, 1e3 * 0.008 / UNITS),
    "kernel_launch_ms.mlp": (MLP, {}, 1e3 * 0.004 / UNITS),
    "cuda_mallocs.mlp": (MLP, {}, 6 / UNITS),
    "status_wait_ms.lm_train": (LM, LM_COUNTERS, 1e3 * 0.012 / UNITS),
    "fwd_stream_ms.lm_train": (LM, LM_COUNTERS, 160.0 / UNITS),
    "bwd_stream_ms.lm_train": (LM, LM_COUNTERS, 440.0 / UNITS),
    "moe_drop_share.lm_train": (LM, LM_COUNTERS, 25.0),
}
ENTRIES = {m["name"]: m for m in
           json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}


def reader(name):
    return manifest.metric_module(ENTRIES[name])


def observed():
    return types.SimpleNamespace(units=UNITS)


def with_session(monkeypatch, spans, counters):
    session = SessionTracer()
    for s in spans:
        session._finish(s)
    for k, v in counters.items():
        session.inc(k, v)
    monkeypatch.setattr(program_spans, "session", lambda: session)


@pytest.mark.parametrize("name", CASES)
def test_reader_reads_the_session(name, monkeypatch):
    spans, counters, want = CASES[name]
    with_session(monkeypatch, spans, counters)
    assert reader(name).read(observed(), name) == pytest.approx(want)


@pytest.mark.parametrize("name", CASES)
def test_reader_without_a_unit_span_reads_none(name, monkeypatch):
    spans, counters, _ = CASES[name]
    unit = "train.step" if name.endswith("lm_train") else "nn2sql.iteration"
    with_session(monkeypatch, [s for s in spans if s.name != unit], counters)
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", CASES)
def test_reader_of_a_program_without_sessions_reads_none(name, monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "profiled")
    assert program_spans.session() is None
    assert reader(name).read(observed(), name) is None


def test_device_time_not_yet_read_gives_none(monkeypatch):
    spans = LM + [span("train.forward", 0.1, 50.0, done=False)]
    with_session(monkeypatch, spans, LM_COUNTERS)
    assert reader("fwd_stream_ms.lm_train").read(observed(), "") is None
    assert reader("bwd_stream_ms.lm_train").read(
        observed(), "") == pytest.approx(110.0)


def test_no_assignments_gives_no_share(monkeypatch):
    with_session(monkeypatch, LM, {})
    assert reader("moe_drop_share.lm_train").read(observed(), "") is None


def test_the_new_metrics_read_no_call_of_the_program():
    """They read the program's spans and counters, and patch nothing."""
    counters = {"cuda_mallocs.mlp", "moe_drop_share.lm_train"}
    for name in CASES:
        assert not getattr(reader(name), "CALLS", {})
        assert ENTRIES[name]["source"] == (
            "program_counter" if name in counters else "program_span")
