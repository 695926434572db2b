"""What every driver shares: the run's context, the measured window and
the outcome it hands to ``run.py``."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Context:
    config: dict                 # configs/<config>.json
    traffic: dict                # traffic/<mix>.json
    seed: int
    seconds: float
    device: str = "cuda"
    trace: bool = False
    #: per-layer metrics of a traced run: name -> module
    metrics: dict = dataclasses.field(default_factory=dict)
    #: time.perf_counter() at process start
    started: float = 0.0
    #: called with the driver's objects once they are built (the tests and
    #: the calibration plant faults through it)
    on_built: Optional[Callable] = None
    #: (what, seconds since process start) of the set-up's stages
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter() - self.started))


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    units: int                   # passes or steps in the window
    end_to_end: dict             # name -> (value, unit); the name is the
    #                              traffic file's ``rate_metric``
    peak_bytes: int
    numbers: dict                # what correctness compares
    #: per traced unit: what the per-layer metrics divide by
    scale: dict = dataclasses.field(default_factory=dict)
    reading: object = None       # trace.Reading of a traced run
    probes: object = None        # trace.Probes of a traced run
    check_s: float = 0.0         # the reference and the comparison
    #: the program's and the reference's readings that ``numbers`` come
    #: from (for the calibration's record)
    readings: dict = dataclasses.field(default_factory=dict)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(unit: Callable[[int], None], seconds: float, device):
    """Run ``unit(i)`` back to back, each ending in a synchronize, until
    ``seconds`` have passed at the end of one: (units, seconds)."""
    synchronize(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        unit(n)
        synchronize(device)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return n, elapsed


def measured(ctx: Context, unit: Callable[[int], None], objects: dict):
    """The window: plain with ``ctx.trace`` off; under the profiler, with
    the cell's per-layer metrics' calls patched, with it on.  Returns
    (units, window seconds, setup seconds, Reading or None, Probes or
    None)."""
    # every run's window starts from the same state of Python's cyclic
    # collector: the engines' evaluations leave their intermediates in
    # reference cycles, and where the collector's rhythm stands at the
    # window's start changed the peak from run to run
    gc.collect()
    setup_s = time.perf_counter() - ctx.started
    if not ctx.trace:
        units, secs = window(unit, ctx.seconds, ctx.device)
        return units, secs, setup_s, None, None
    from . import trace
    probes = trace.Probes()
    for name, mod in ctx.metrics.items():
        probes.install(name, getattr(mod, "CALLS", {}), objects)
    # a traced window holds every launch and host op in memory: the
    # traffic file bounds its length
    seconds = min(ctx.seconds, ctx.traffic.get("trace_seconds", ctx.seconds))
    probes.active = True
    try:
        (units, secs), reading = trace.traced(
            lambda: window(unit, seconds, ctx.device), list(ctx.metrics),
            ctx.device)
    finally:
        probes.active = False
        probes.remove()
    return units, secs, setup_s, reading, probes


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0
