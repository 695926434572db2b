"""The readers of the optimizer tail's fused share
(``optim_fused_share.lm_train`` and ``optim_fused_share.hybrid_train``),
held to a hand-built session of the program's own ``SessionTracer`` as
the other counter readers are: 100 where the counters say every updated
element went through the fused kernel, the share where they say less,
and None where the session holds no unit span, where the program keeps no
session, or where it counts no update on the card (a program without the
kernel, or a window of CPU steps)."""
import pytest

from portbench import program_spans
from portbench.tests.test_portbench_program_spans import (
    ENTRIES, LM, LM_COUNTERS, observed, reader, with_session)

NAMES = ["optim_fused_share.lm_train", "optim_fused_share.hybrid_train"]
#: 4 steps of 2,839,831,040 elements, all through the kernel
FUSED = {**LM_COUNTERS, "optim.elems": 4 * 2_839_831_040,
         "optim.fused": 4 * 2_839_831_040}


@pytest.mark.parametrize("fused,want", [(1.0, 100.0), (0.25, 25.0),
                                        (0.0, 0.0)])
@pytest.mark.parametrize("name", NAMES)
def test_fused_share_reads_the_session(name, fused, want, monkeypatch):
    counters = {**FUSED, "optim.fused": int(fused * FUSED["optim.elems"])}
    with_session(monkeypatch, LM, counters)
    assert reader(name).read(observed(), name) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_fused_share_without_a_unit_span_reads_none(name, monkeypatch):
    with_session(monkeypatch, [s for s in LM if s.name != "train.step"],
                 FUSED)
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", NAMES)
def test_fused_share_of_a_program_without_sessions_reads_none(
        name, monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "profiled")
    assert program_spans.session() is None
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_counters_gives_no_fused_share(name,
                                                             monkeypatch):
    """The parent's program counts no optimizer element: the share is left
    out, not read as 0."""
    with_session(monkeypatch, LM, LM_COUNTERS)
    assert reader(name).read(observed(), name) is None


@pytest.mark.parametrize("name", NAMES)
def test_fused_share_reads_counters_and_calls_nothing(name):
    """It reads the program's counters, patches no call, and names the
    layer ``optim_ms`` names."""
    assert not getattr(reader(name), "CALLS", {})
    assert ENTRIES[name]["source"] == "program_counter"
    optim_ms = "optim_ms." + name.split(".")[1]
    assert ENTRIES[name]["layer"] == ENTRIES[optim_ms]["layer"]
    assert ENTRIES[name]["workloads"] == ENTRIES[optim_ms]["workloads"]
