"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and what the plain reference works out, and is held
against a limit of its own (``limits/<cell>.json``)."""
from __future__ import annotations

import math
import statistics


def norm_gap(program: dict, reference: dict, leaves=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = sorted(reference) if leaves is None else sorted(leaves)
    median = statistics.median(reference[n] for n in reference)

    def gap(n):
        scale = max(reference[n], median)
        diff = abs(program[n] - reference[n])
        return diff / scale if scale else (0.0 if diff == 0 else math.inf)
    return max(gap(n) for n in names)


def moving_leaves(grad1: dict, share: float = 1e-3) -> list:
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's: the others move under Adam by
    round-off alone."""
    median = statistics.median(grad1.values())
    return [n for n, g in grad1.items() if g >= share * median]


def relative_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def train_numbers(program: dict, reference: dict) -> dict:
    """A training cell's numbers from two readings {"loss": [...],
    "grads": [{leaf: norm} a step], "change": {leaf: norm}} ("loss" and
    "change" may be absent): the loss of each step and of the first
    alone, each step's gradient by the worst leaf, the change after the
    steps by the worst moving leaf."""
    out = {}
    if "loss" in reference:
        out["loss_gap"] = relative_gap(program["loss"], reference["loss"])
        out["first_loss_gap"] = relative_gap(program["loss"][:1],
                                             reference["loss"][:1])
    out["grad_gap"] = max(norm_gap(p, r) for p, r in
                          zip(program["grads"], reference["grads"]))
    if "change" in reference:
        out["change_gap"] = norm_gap(program["change"], reference["change"],
                                     moving_leaves(reference["grads"][0]))
    return out


def verdict(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited number; a number the
    run did not read, or read as not finite, is None and fails."""
    def finite(x):
        return x if x is not None and math.isfinite(x) else None
    return {name: {"value": finite(numbers.get(name)), "limit": lim}
            for name, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
