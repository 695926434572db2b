"""BENCHMARK.json against the contract it is written to, and every file
of each cell found by name."""
import json
import re

import pytest

from portbench import manifest
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: what ``reduced`` may never name: a width, a head size, an expansion
#: factor or the number of experts per token
WIDTH = re.compile(r"(_dim|_rank|_size|width)$|intermediate|latent|state|"
                   r"proj|head_dim|expan|experts_per_tok")


def test_keys_and_counts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(p == "portbench" or p.startswith("portbench/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32


def test_the_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
        assert c["file"].startswith("portbench/configs/")
        on_disk = json.loads((ROOT / c["file"]).read_text())
        assert all(k in on_disk for k in c["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = manifest.cell(ROOT, cell)
    assert c.limits and c.end_to_end and c.per_layer
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in c.per_layer:
        mod = manifest.metric_module(m)
        assert callable(mod.read)
        assert m["moves"] in names


def test_every_metric_moves_a_metric_of_its_cells():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads",
                                              m["workloads"]))
