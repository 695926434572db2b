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


def from_jax_params(params: dict, device="cuda") -> dict:
    """{name: array or nested dict} (numpy or JAX arrays) → the same tree
    of tensors on ``device``, each leaf keeping its dtype.  A JAX
    ``LM.init`` tree (stacked layer axis included) becomes the port's
    ``LM`` parameters unchanged."""
    dev = resolve(device)
    return {k: from_jax_params(v, dev) if isinstance(v, dict)
            else _tensor(v).to(dev) for k, v in params.items()}


def to_numpy(tensors: dict) -> dict:
    """{name: tensor or nested dict} → the same tree of numpy arrays on the
    host (bf16 as float32, which holds it exactly)."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in tensors.items()}


def from_jax_opt_state(state, device="cuda"):
    """An optimizer state of the JAX package → the port's, on ``device``:
    ``adamw``'s {"m", "v", "t", "master"?} tree for tree (``t`` an int32
    scalar tensor), ``sgd``'s ``()`` as it is."""
    return () if state == () else from_jax_params(state, device)


def to_jax_opt_state(state):
    """The port's optimizer state → numpy arrays the JAX package's
    ``update`` takes (``()`` stays ``()``)."""
    return () if state == () else to_numpy(state)
