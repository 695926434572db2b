"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration, traffic mix, limits and per-layer metric readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name,
        config=load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json")["limits"],
        chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_module(entry: dict):
    """``metrics/<name>.py``, checked against its manifest entry."""
    path = HERE / "metrics" / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + entry["name"].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key in ("layer", "unit", "better", "moves"):
        if getattr(mod, key.upper()) != entry[key]:
            raise ValueError(f"{path.name}: {key} {getattr(mod, key.upper())!r}"
                             f" but BENCHMARK.json says {entry[key]!r}")
    return mod
