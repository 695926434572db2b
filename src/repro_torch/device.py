"""Device choice for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU.  Without a CUDA
device it raises; it never drops to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev
