#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size (``python3 portbench/calibrate.py --workload <cell>
--seeds 12 --control-seeds 3 --out <file.json>``):

* ``program``: the numbers of sound runs of the program (set-up, one unit
  of the window, the comparison), one a seed: the lower readings;
* ``control``: the plain reference computed in the precision below the
  configuration's (TF32 for the float32 MLP, fp8 for bf16 DeepSeek) in
  the program's place, against the reference: an upper reading;
* ``faults``: each fault of ``faults.FAULTS`` planted in the program.

The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# many runs in one process: let the allocator map memory in growable
# segments, so that one run's layout does not fragment the next
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from portbench import compare, faults, harness, manifest  # noqa: E402

CONTROL = {"float32": ("float64", "tf32"), "bfloat16": ("bf16", "fp8")}


def program_numbers(cell, seed: int, device, fault=None, record=None
                    ) -> dict:
    import importlib
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    planted = faults.Planted(fault) if fault else None
    ctx = harness.Context(config=cell.config, traffic=cell.traffic, seed=seed,
                          seconds=0.0, device=device,
                          started=time.perf_counter(), on_built=planted)
    try:
        out = driver.run(ctx)
        if record is not None:
            record[seed] = out.readings
    finally:
        if planted:
            planted.close()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out.numbers


def control_numbers(cell, seed: int, device) -> dict:
    """The reference in the precision below the configuration's, in the
    program's place."""
    tr = cell.traffic
    if tr["driver"] == "mlp":
        from portbench.drivers import mlp
        stated, below = CONTROL[cell.config["precision"]]
        r = mlp.control_readings(cell.config, tr, seed, device, below, stated)
        return compare.train_numbers(r["program"], r["reference"])
    from portbench.reference import deepseek as ref
    stated, below = CONTROL[cell.config["compute_dtype"]]
    low = ref.train(cell.config, tr, seed, device, precision=below)
    gc.collect()
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    want = ref.train(cell.config, tr, seed, device, precision=stated)
    as_prog = lambda r: {"loss": r["loss"], "grads": [r["grad1"]],
                         "change": r["change"]}
    return compare.train_numbers(as_prog(low), as_prog(want))


def main(argv=None, device="cuda", resize=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    ap.add_argument("--parts", default="program,control,faults")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = manifest.cell(ROOT, args.workload)
    if resize:
        resize(cell)
    parts = args.parts.split(",")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {}, "readings": {}}
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    for i, seed in enumerate(seeds):
        if "program" in parts:
            out["program"][seed] = program_numbers(cell, seed, device,
                                                   record=out["readings"])
            print("program", seed, out["program"][seed], flush=True)
        if i < args.control_seeds:
            if "control" in parts:
                out["control"][seed] = control_numbers(cell, seed, device)
                print("control", seed, out["control"][seed], flush=True)
            if "faults" in parts:
                for fault in faults.FAULTS[cell.traffic["driver"]]:
                    got = program_numbers(cell, seed, device, fault)
                    out["faults"].setdefault(fault, {})[seed] = got
                    print("fault", fault, seed, got, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
