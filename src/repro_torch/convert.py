"""Carry weights between the JAX package and the port as numpy arrays, so
both compute from the same numbers."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def _tensor(a) -> torch.Tensor:
    """A copy: JAX hands out read-only buffers, which a tensor must not
    alias."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy has no bf16 torch can read
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def from_jax_params(params: dict, device="cuda") -> dict[str, torch.Tensor]:
    """{name: array} (numpy or JAX arrays) → {name: tensor on device}."""
    dev = resolve(device)
    return {k: _tensor(v).to(dev) for k, v in params.items()}


def to_numpy(tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """{name: tensor} → {name: numpy array} on the host (bf16 as float32,
    which holds it exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in tensors.items()}
