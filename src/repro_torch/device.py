"""Device choice for the port's entry points, and the host boundary.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU.  Without a CUDA
device it raises; it never drops to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev


def to_host(x, dtype=np.float64) -> np.ndarray:
    """The one crossing from the port's tensors to the database's values.

    The SQL tier executes in the database, on the host: a leaf it ingests,
    a weight it updates or a result it compares is a numpy array there.
    A tensor (on the card or not) is detached and copied to the host here,
    explicitly; numpy arrays and lists pass through.  ``dtype=None`` keeps
    the source's element type (the leaf digest folds it in)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)
