"""The repository's examples on the port, one module each, named as the
JAX package's scripts in ``examples/`` are::

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # the host

Each takes its reference script's flags and ``--device`` (default
``"cuda"``: without a card it raises, unless given ``--device cpu``),
prints what the reference script prints, and its ``main(argv)`` returns
those numbers as a dict.  The computation sits in a function that takes
its weights from the caller, so a test can feed it the JAX package's.
"""
from __future__ import annotations

import time

import torch


def timed(fn, device: torch.device):
    """``fn()`` and its wall seconds; on the card, synchronised before and
    after, so the seconds hold the device's work."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda _device: None)
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0
