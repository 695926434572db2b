#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs from the seed on
the card, warms up every shape the cell uses (set-up), measures for
``--seconds`` (``--trace 1``: under the profiler, with the per-layer
metrics' ranges in place), checks what the timed path produced against
the plain reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error).  Without a CUDA card, or
with fewer than the cell asks for, it exits 2 and prints no result; if a
module of JAX or of the JAX package is loaded once the window has
closed, it exits 3 and prints none."""
import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the moment this process started (from
    /proc; the interpreter's start is a few tens of milliseconds)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Observed:
    """What a per-layer metric reads: the traced window and the work and
    device time of its ranges."""

    def __init__(self, outcome):
        r, p = outcome.reading, outcome.probes
        self.window_s, self.busy_s = r.window_s, r.busy_s
        self.range_s, self.work, self.calls = r.range_s, p.work, p.calls
        self.units = outcome.scale["units"]
        self.model_flops = outcome.scale["model_flops"]

    def roofline(self, name):
        """100 x least time / device time of a metric's calls; None where
        its calls did not run or ran nothing on the device."""
        if not self.calls[name] or not self.range_s.get(name):
            return None
        return 100.0 * self.work[name] / self.range_s[name]


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches() -> None:
    """Kernel caches live at fixed paths inside the checkout, so that only
    a checkout's first run builds (the port's own CUDA kernels build into
    ``build/repro_torch_kernels``, which its build module fixes)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))


def main(argv=None, device="cuda", on_built=None, resize=None,
         out=None) -> int:
    """``device`` other than "cuda", ``on_built`` and ``resize`` are for
    the tests: they skip the look for a card, plant faults and shrink the
    cell to a size a test run holds."""
    args = _parse(argv)
    out = out or sys.stdout
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from portbench import guard, manifest
    _caches()
    cell = manifest.cell(ROOT, args.workload)
    if resize:
        resize(cell)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: no result", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                  f"{cell.chips}: no result", file=sys.stderr)
            return 2
    from portbench import compare, harness
    import importlib
    metrics = ({m["name"]: manifest.metric_module(m) for m in cell.per_layer}
               if args.trace else {})
    ctx = harness.Context(config=cell.config, traffic=cell.traffic,
                          seed=args.seed, seconds=args.seconds, device=device,
                          trace=bool(args.trace), metrics=metrics,
                          started=STARTED, on_built=on_built)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    outcome = driver.run(ctx)
    loaded = guard.forbidden_loaded()
    if loaded:
        print("forbidden modules loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 3
    checks = compare.verdict(outcome.numbers, cell.limits)
    correct = compare.passed(checks)
    if args.trace:
        obs = Observed(outcome)
        values = {}
        for name, mod in metrics.items():
            v = mod.read(obs, name)
            if v is not None:
                values[name] = {"value": v, "unit": mod.UNIT}
    else:
        readings = dict(outcome.end_to_end)
        readings["setup_s"] = (outcome.setup_s, "s")
        readings["peak_mem_gib"] = (outcome.peak_bytes / 2 ** 30, "GiB")
        values = {}
        for m in cell.end_to_end:
            value, unit = readings[m["name"]]
            values[m["name"]] = {"value": value, "unit": unit}
    kind = (torch.cuda.get_device_name(0) if device == "cuda"
            else str(device))
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": kind, "count": cell.chips,
           "memory_peak_bytes": outcome.peak_bytes}
    line = {"correct": correct, "attempted": outcome.units,
            "failed": 0 if correct else outcome.units,
            "metrics": values, "device": dev}
    if args.trace:
        r = outcome.reading
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
        line["breakdown"] = {"device_ops": r.device_ops,
                             "idle_gaps": r.idle_gaps}
    line["checks"] = checks
    print("set-up stages (s from process start): " + ", ".join(
        f"{what} {at:.3f}" for what, at in ctx.marks), file=sys.stderr)
    print(f"set-up {outcome.setup_s:.3f} s, window {outcome.window_s:.3f} s "
          f"({outcome.units} units), reference and comparison "
          f"{outcome.check_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
