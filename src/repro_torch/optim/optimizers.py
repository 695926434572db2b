"""Optimizers, PyTorch port of ``repro.optim.optimizers``: SGD (the
paper's) and AdamW, with the global-norm clip.

Interface, as in the JAX package: ``opt.init(params) → state``;
``opt.update(grads, state, params) → (new_params, new_state)``, over
nested dicts (or tuples and lists) of tensors.  The formulas and their
order are the JAX package's.

What differs: ``update`` works in place, under ``torch.no_grad()``.  It
writes the new values into the ``params`` and ``state`` tensors it is
given and returns those same trees; temporaries are made one leaf at a
time.  That is the effect of JAX's ``donate_argnums``: the old parameters
and moments are not kept beside the new ones, which at 2.6 B float32
parameters (one stacked SwiGLU leaf is 2.2 GB) decides whether a step fits
the card.  ``state["t"]`` is an int32 scalar tensor on the parameters'
device, so the bias corrections are computed there, as JAX computes them,
without a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def sgd(lr: float) -> Optimizer:
    """Plain gradient descent — Listing 1/7/10's ``w - γ·d_w``."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        for p, g in zip(leaves(params), leaves(grads)):
            p.sub_(lr * g.to(p.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          mixed_precision: bool = False) -> Optimizer:
    """AdamW. With ``mixed_precision`` the optimizer carries float32 MASTER
    weights and the (bf16) params are re-cast from them each step — the
    standard low-precision-parameter scheme: forward reads move bf16,
    optimizer math stays exact."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        device = leaves(params)[0].device
        st = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
              "t": torch.zeros((), dtype=torch.int32, device=device)}
        if mixed_precision:
            st["master"] = tree_map(lambda p: p.to(torch.float32).clone(),
                                    params)
        return st

    @torch.no_grad()
    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=tf.device), tf)
        b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=tf.device), tf)
        masters = state.get("master", params)
        for p, mast, g, m, v in zip(leaves(params), leaves(masters),
                                    leaves(grads), leaves(state["m"]),
                                    leaves(state["v"])):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step = (m / b1t).div_((v / b2t).sqrt_().add_(eps))
            # new_mast = mast - lr (step + wd mast), into the float32
            # master itself (the parameter when there is no master)
            new_mast = (mast if mast.dtype == torch.float32
                        else mast.to(torch.float32))
            new_mast.sub_(step.add_(weight_decay * new_mast).mul_(lr))
            if p is not new_mast:
                p.copy_(new_mast)
        state["t"].copy_(t)
        return params, state

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32 (the leaves summed in JAX's order)."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)), in place;
    returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
