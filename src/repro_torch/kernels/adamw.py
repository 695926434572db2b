"""The LM training step's optimizer tail on the card: the wrappers of
``csrc/adamw.cu`` (the source says what bounds it and how it is built).

``global_norm`` is the clip's pass: one read of every gradient leaf, the
norm of the leaves over ``divisor`` and the factor min(1, max_norm /
(norm + 1e-9)), both left on the device.  ``adamw_update`` is AdamW in
one pass over every leaf, with the division and the clip folded into its
read of the gradient.  Each launch covers every leaf of the step: the
wrapper builds a table of them (pointers, size, first chunk, flags), pins
it and copies it to the device on the current stream; nothing waits for
the device, and every buffer comes from PyTorch's caching allocators.

Their plain twins are the per-leaf PyTorch code of
``repro_torch.optim.optimizers`` (``global_norm``, ``adamw``'s update),
which CPU leaves take; given the same factor the kernel's update is that
code's bit for bit on the card, and the norm sums in another, fixed,
order.  A CUDA leaf the kernels cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import tracer as obs
from . import build

#: elements a block takes at a time (``kChunk`` in the source)
CHUNK = 16384
#: a leaf's flags (the source's kParamBf16, kMaster, kAligned)
_BF16, _MASTER, _ALIGNED = 1, 2, 4

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "norm_launch": [_P, _I, _L, _F, _F, _P, _P, _I, _P],
    "update_launch": [_P, _I, _L, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _F,
                      _I, _P],
}


def _reciprocal(divisor: int) -> float:
    """1 / divisor rounded to float32, as PyTorch's CUDA ``div_`` by a
    Python number multiplies by it."""
    return float(torch.ones((), dtype=torch.float32) / divisor)


def _device(tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("optimizer kernels: every leaf on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    return dev


def _check(t: torch.Tensor, dtypes, what: str, numel: int) -> int:
    """``t``'s address, once it is contiguous, of a type in ``dtypes`` and
    of ``numel`` elements; raises otherwise."""
    if t.dtype not in dtypes:
        raise TypeError(f"optimizer kernels: {what} of type {t.dtype}, "
                        f"expected one of {dtypes}")
    if not t.is_contiguous() or t.numel() != numel:
        raise ValueError(f"optimizer kernels: {what} must be contiguous with "
                         f"{numel} elements, got shape {tuple(t.shape)} and "
                         f"strides {t.stride()}")
    return t.data_ptr()


def _table(rows: list, dev: torch.device) -> torch.Tensor:
    """The leaves' table on ``dev``: pinned, copied on the current stream
    (the caching host allocator keeps the pinned block until the copy is
    done)."""
    return torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)


def global_norm(grads: list, divisor: int, max_norm: float) -> torch.Tensor:
    """(2,) float32 on the gradients' device: the norm of the leaves over
    ``divisor`` (float32 sums in a fixed order: two calls give the same
    bits) and min(1, max_norm / (norm + 1e-9)).  Every leaf float32 and
    contiguous."""
    dev = _device(grads)
    rows, chunks = [], 0
    for i, g in enumerate(grads):
        n = g.numel()
        ptr = _check(g, (torch.float32,), f"gradient {i}", n)
        if n:
            rows.append((ptr, 0, 0, 0, 0, n, chunks,
                         _ALIGNED if ptr % 16 == 0 else 0))
            chunks += -(-n // CHUNK)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    partials = torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
    with obs.span("kernels.global_norm", leaves=len(rows)):
        table = _table(rows or [(0,) * 8], dev)
        lib = build.library("adamw", _SIGNATURES)
        device, stream = build.device_and_stream(out)
        with obs.span("kernels.launch"):
            rc = lib.norm_launch(table.data_ptr(), len(rows), chunks,
                                 _reciprocal(divisor), max_norm,
                                 partials.data_ptr(), out.data_ptr(), device,
                                 stream)
        build.check(rc, "global_norm")
        global_norm.launches += 1
    return out


global_norm.launches = 0


def adamw_update(params: list, masters: list, grads: list, ms: list,
                 vs: list, b1t: torch.Tensor, b2t: torch.Tensor, *,
                 lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, grad_scale=None) -> int:
    """AdamW over every leaf in place: leaf i's gradient ``grads[i]`` over
    the divisor of ``grad_scale`` (a ``GradScale``; none where None), times
    its factor (a float32 scalar on the device), updates ``ms[i]``,
    ``vs[i]`` and the float32 ``masters[i]``, then re-casts ``params[i]``
    from it; where ``masters[i] is params[i]`` (no master) the parameter
    itself, float32 or bf16, is updated.  b1t and b2t are the step's bias
    corrections, float32 scalars on the device.  The gradients are left as
    they are.  Returns the number of elements updated."""
    divisor, factor = grad_scale or (1, None)
    dev = _device([*params, *masters, *grads, *ms, *vs, b1t, b2t]
                  + ([] if factor is None else [factor]))
    for name, t in (("b1t", b1t), ("b2t", b2t), ("factor", factor)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
            raise TypeError(f"optimizer kernels: {name} a float32 scalar")
    f32 = (torch.float32,)
    rows, chunks, total = [], 0, 0
    for i, (p, mast, g, m, v) in enumerate(zip(params, masters, grads, ms, vs,
                                               strict=True)):
        n = p.numel()
        ptrs = [_check(p, (torch.float32, torch.bfloat16), f"parameter {i}",
                       n),
                _check(g, f32, f"gradient {i}", n),
                _check(m, f32, f"first moment {i}", n),
                _check(v, f32, f"second moment {i}", n)]
        flags = _BF16 if p.dtype == torch.bfloat16 else 0
        master = 0
        if mast is not p:
            master = _check(mast, f32, f"master {i}", n)
            ptrs.append(master)
            flags |= _MASTER
        if all(q % 16 == 0 for q in ptrs[1:]) and ptrs[0] % (
                8 if flags & _BF16 else 16) == 0:
            flags |= _ALIGNED
        if n:
            rows.append((ptrs[1], ptrs[2], ptrs[3], ptrs[0], master, n,
                         chunks, flags))
            chunks += -(-n // CHUNK)
            total += n
    if not rows:
        return 0
    with obs.span("kernels.adamw", leaves=len(rows)):
        table = _table(rows, dev)
        lib = build.library("adamw", _SIGNATURES)
        device, stream = build.device_and_stream(b1t)
        with obs.span("kernels.launch"):
            rc = lib.update_launch(
                table.data_ptr(), len(rows), chunks, b1t.data_ptr(),
                b2t.data_ptr(), None if factor is None else factor.data_ptr(),
                lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
                _reciprocal(divisor), device, stream)
        build.check(rc, "adamw")
        adamw_update.launches += 1
    obs.inc("optim.fused", total)
    return total


adamw_update.launches = 0
