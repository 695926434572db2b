#!/usr/bin/env python3
"""``calibrate.py`` for the Zamba2 cells (driver ``hybrid_train``), which
that module's tables predate: the same readings (``program``, ``control``,
``faults``), the control being ``reference/zamba2.py`` in fp8 (e4m3
forward, e5m2 gradients) in the program's place against it in bf16, the
faults those of ``lm_train`` (a step that leaves the state unchanged, a
step on half the batch):

    python3 portbench/calibrate_hybrid.py --workload <cell> --seeds 6 \\
        --control-seeds 3 --out <file.json>

``register()`` adds the driver to ``faults.FAULTS`` and its control to
``calibrate.control_numbers``; the benchmark's own runs never call it."""
from __future__ import annotations

import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench import calibrate, compare, faults, sampled  # noqa: E402

DRIVER = "hybrid_train"


def control_numbers(cell, seed: int, device) -> dict:
    """The reference in fp8 against the reference in bf16."""
    from portbench.reference import zamba2 as ref
    stated, below = calibrate.CONTROL[cell.config["compute_dtype"]]
    low = ref.train(cell.config, cell.traffic, seed, device, precision=below)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = ref.train(cell.config, cell.traffic, seed, device,
                     precision=stated)
    as_prog = lambda r: {"loss": r["loss"], "grads": [r["grad1"]],
                         "change": r["change"]}
    numbers = compare.train_numbers(as_prog(low), as_prog(want))
    numbers["grad_sample_gap"] = sampled.gap(low["sample1"],
                                             want["sample1"])
    return numbers


def register() -> None:
    faults.FAULTS.setdefault(DRIVER, faults.FAULTS["lm_train"])
    current = calibrate.control_numbers
    if getattr(current, "hybrid", False):
        return

    def dispatch(cell, seed, device):
        if cell.traffic["driver"] == DRIVER:
            return control_numbers(cell, seed, device)
        return current(cell, seed, device)

    dispatch.hybrid = True
    calibrate.control_numbers = dispatch


if __name__ == "__main__":
    register()
    calibrate.main()
