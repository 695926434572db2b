"""The readers of ``relational_matmul``'s route shares
(``relmm_kslab_share.mlp`` and ``relmm_kslab_share.lm_train``), held to a
hand-built session of the program's own ``SessionTracer`` as the other
span and counter readers are: the share they should read, and None where
the session holds no unit span, where the program keeps no session, or
where it counts no routes (a program without the long-segment schedule)."""
import pytest

from portbench import program_spans
from portbench.tests.test_portbench_program_spans import (
    ENTRIES, LM, LM_COUNTERS, MLP, observed, reader, with_session)

#: the relational_matmul calls of 4 MLP passes (2 of 5 a pass kslab) and of
#: 4 LM steps (the MoE's, all stream)
MLP_ROUTES = {"relmm.calls": 20, "relmm.kslab": 8, "relmm.slab": 8,
              "relmm.stream": 4}
LM_ROUTES = {**LM_COUNTERS, "relmm.calls": 128, "relmm.stream": 128}

#: metric -> (session's spans, counters, the reading, the unit span)
CASES = {
    "relmm_kslab_share.mlp": (MLP, MLP_ROUTES, 40.0, "nn2sql.iteration"),
    "relmm_kslab_share.lm_train": (LM, LM_ROUTES, 0.0, "train.step"),
}


@pytest.mark.parametrize("name", CASES)
def test_route_share_reads_the_session(name, monkeypatch):
    spans, counters, want, _ = CASES[name]
    with_session(monkeypatch, spans, counters)
    assert reader(name).read(observed(), name) == pytest.approx(want)


@pytest.mark.parametrize("name", CASES)
def test_route_share_without_a_unit_span_reads_none(name, monkeypatch):
    spans, counters, _, unit = CASES[name]
    with_session(monkeypatch, [s for s in spans if s.name != unit], counters)
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", CASES)
def test_route_share_of_a_program_without_sessions_reads_none(
        name, monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "profiled")
    assert program_spans.session() is None
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", CASES)
def test_a_program_without_route_counters_gives_no_route_share(
        name, monkeypatch):
    """A program that counts no routes leaves the share out, and does not
    read it as 0."""
    spans, _, _, _ = CASES[name]
    with_session(monkeypatch, spans, LM_COUNTERS)
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", CASES)
def test_route_share_reads_counters_and_calls_nothing(name):
    """It reads the program's counters, and patches no call."""
    assert not getattr(reader(name), "CALLS", {})
    assert ENTRIES[name]["source"] == "program_counter"
    assert ENTRIES[name]["layer"] == "kernels"
