"""A sample of each gradient leaf's elements, for a comparison element by
element.  ``compare.norm_gap`` holds the norm of each leaf's gradient, and
an error that is not along the gradient barely moves a norm (to first
order, by its projection on the gradient): the rounding of bf16 and of fp8
products both read as a fraction of a percent there.  The same
gradients compared element by element part by about the operands'
rounding, which fp8 makes sixteen times bf16's.  So the first step's
gradient is also kept at ``SAMPLE`` positions of each leaf, drawn once
from a fixed generator, and compared as a distance."""
from __future__ import annotations

import statistics

import torch

#: positions kept a leaf (every element of a smaller leaf)
SAMPLE = 4096
_SEED = 34_224


def positions(numel: int, device) -> torch.Tensor:
    """The sampled positions of a flat leaf of ``numel`` elements: the
    same for every run on every device."""
    if numel <= SAMPLE:
        return torch.arange(numel, device=device)
    gen = torch.Generator().manual_seed(_SEED + numel)
    return torch.randint(0, numel, (SAMPLE,), generator=gen).to(device)


def sample(items) -> dict:
    """{leaf: its values at ``positions``, float64 on the host} of (name,
    tensor) pairs."""
    return {n: t.detach().reshape(-1)[positions(t.numel(), t.device)]
            .double().cpu() for n, t in items}


def gap(program: dict, reference: dict) -> float:
    """The worst leaf's distance between the two samples, over the
    reference sample's norm or the median leaf's, whichever is larger."""
    norms = {n: float(torch.linalg.vector_norm(r))
             for n, r in reference.items()}
    median = statistics.median(norms.values())
    return max(float(torch.linalg.vector_norm(program[n] - r))
               / max(norms[n], median) for n, r in reference.items())
