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

On the card the LM training step's tail runs as two kernels
(``kernels/adamw.py``): ``clip_by_global_norm(..., divide_by=k)`` reads
every gradient once for the norm of their average and leaves the division
and the clip to AdamW's update, which applies them as it reads each
gradient (``GradScale``), in one pass over every leaf.  Which path runs
follows the leaves: CUDA leaves take the kernels (or raise where they
cannot), CPU and meta leaves the per-leaf PyTorch code below, which is
the kernels' plain twin: given the same factor the two update to the same
bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..kernels import adamw as fused
from ..obs import tracer as obs
from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    #: ``update`` takes ``grad_scale=`` (a ``GradScale``) and applies it to
    #: each gradient as it reads it
    folds_grad_scale: bool = False


class GradScale(NamedTuple):
    """The division and the clip that ``clip_by_global_norm(...,
    divide_by=k)`` leaves to the update: each gradient is divided by
    ``divisor`` (the microbatches it summed), then multiplied by
    ``factor`` (a 0-dim float32 tensor on the gradients' device)."""
    divisor: int
    factor: torch.Tensor


def apply_grad_scale(grads, scale: GradScale):
    """``scale`` applied to every leaf in place, in the trainer's old order
    (divide, then clip); returns ``grads``."""
    for g in leaves(grads):
        if scale.divisor != 1:
            g.div_(scale.divisor)
        g.mul_(scale.factor.to(g.dtype))
    return grads


def _on_card(*trees) -> bool:
    return any(t.is_cuda for tree in trees for t in tree)


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
    def update(grads, state, params, grad_scale: GradScale | None = None):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=tf.device), tf)
        b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=tf.device), tf)
        trees = [leaves(params), leaves(state.get("master", params)),
                 leaves(grads), leaves(state["m"]), leaves(state["v"])]
        hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     grad_scale=grad_scale)
        if _on_card(*trees):
            fused.adamw_update(*trees, b1t, b2t, **hyper)
            obs.inc("optim.elems", sum(p.numel() for p in trees[0]))
        else:
            adamw_plain(*trees, b1t, b2t, **hyper)
        state["t"].copy_(t)
        return params, state

    return Optimizer(init, update, folds_grad_scale=True)


@torch.no_grad()
def adamw_plain(params: list, masters: list, grads: list, ms: list, vs: list,
                b1t: torch.Tensor, b2t: torch.Tensor, *, lr: float,
                b1: float, b2: float, eps: float, weight_decay: float,
                grad_scale: GradScale | None = None) -> None:
    """AdamW over lists of leaves in place, one leaf at a time in PyTorch
    (``masters[i] is params[i]`` where there is no master): what CPU and
    meta leaves run, and the plain twin of ``kernels.adamw.adamw_update``.
    ``grad_scale`` is applied to each gradient in place first."""
    for p, mast, g, m, v in zip(params, masters, grads, ms, vs, strict=True):
        if grad_scale is not None:
            apply_grad_scale(g, grad_scale)
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / b1t).div_((v / b2t).sqrt_().add_(eps))
        # new_mast = mast - lr (step + wd mast), into the float32 master
        # itself (the parameter when there is no master)
        new_mast = (mast if mast.dtype == torch.float32
                    else mast.to(torch.float32))
        new_mast.sub_(step.add_(weight_decay * new_mast).mul_(lr))
        if p is not new_mast:
            p.copy_(new_mast)


def global_norm(tree, divide_by: int = 1) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32 (the leaves summed in JAX's order); with ``divide_by``, of each
    leaf divided by it (one leaf's quotient at a time)."""
    total = None
    for x in leaves(tree):
        if divide_by != 1:
            x = x / divide_by
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, divide_by: int | None = None):
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)), in place;
    returns (grads, norm).

    With ``divide_by`` (the microbatches the leaves summed; 1 for one) the
    leaves are left as they are: ``norm`` is that of the leaves over
    ``divide_by``, and (grads, norm, scale) come back, ``scale`` the
    ``GradScale`` of the division and the clip, for an update that folds
    it in or for ``apply_grad_scale``.  CUDA leaves take the
    ``global_norm`` kernel: one read of every leaf, the norm and the factor
    left on the device."""
    if divide_by is not None:
        if _on_card(leaves(grads)):
            out = fused.global_norm(leaves(grads), divide_by, max_norm)
            return grads, out[0], GradScale(divide_by, out[1])
        norm = global_norm(grads, divide_by)
        factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        return grads, norm, GradScale(divide_by, factor)
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
