"""The shape of the last line, a run without a card, and the faults and
the control at a small size: each has to turn ``correct`` false."""
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, compare, faults, manifest, run
from portbench.tests import small
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, trace=0, seed=5, on_built=None):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", str(trace)], device="cpu",
                  resize=small.resize, on_built=on_built, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, trace):
    line = _run(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    c = manifest.cell(ROOT, cell)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == set(c.limits)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = io.StringIO()
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                  out=out)
    assert rc == 2 and out.getvalue() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


FAULTY = [(cell, fault) for cell in CELLS
          for fault in faults.FAULTS[manifest.cell(ROOT, cell)
                                     .traffic["driver"]]]


@pytest.mark.parametrize("cell,fault", FAULTY)
def test_a_planted_fault_is_not_correct(cell, fault):
    planted = faults.Planted(fault)
    try:
        line = _run(cell, on_built=planted)
    finally:
        planted.close()
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, parts from the reference at a small size by three
    times what a sound run of the program does or more, on a number the
    cell compares (the limits themselves are set at the cell's own size,
    where ``-m cuda`` holds the control to them)."""
    c = manifest.cell(ROOT, cell)
    small.resize(c)
    for seed in (5, 6):
        control = calibrate.control_numbers(c, seed, "cpu")
        sound = calibrate.program_numbers(c, seed, "cpu")
        assert any(control[n] >= 3 * sound[n] for n in c.limits), (
            control, sound)


@pytest.mark.parametrize("cell", CELLS)
def test_each_limit_lies_between_its_readings(cell):
    """Every limit lies above the largest reading of sound runs and below
    the smallest of the control or a fault, which reads three times the
    lower or more."""
    doc = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json")
                     .read_text())
    for name, limit in doc["limits"].items():
        r = doc["readings"][name]
        assert r["lower"] < limit < r["upper"], (name, r, limit)
        assert r["upper"] >= 3 * r["lower"], (name, r)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    c = manifest.cell(ROOT, cell)
    for seed in (1_000_003, 1_007_922, 1_015_841):
        numbers = calibrate.control_numbers(c, seed, "cuda")
        assert not compare.passed(compare.verdict(numbers, c.limits))
