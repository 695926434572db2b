"""MoE dispatch on the card: the wrapper of ``csrc/moe_dispatch.cu`` (one
warp per slot row, four 16-byte loads in flight a lane, x kept in L2 and
the output streamed past it; the source says what bounds it).  It replaces
the Pallas TPU kernel ``repro.kernels.moe_dispatch``; ``plain`` is its
PyTorch twin.  An index outside 0..t-1 raises ``ValueError`` from the call
(the kernel writes a zero row for it and raises the device's status flag;
the C launcher waits for this kernel alone, reads the flag from pinned host
memory and clears it).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

plain = ref.moe_dispatch

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"moe_dispatch_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BAD_INDEX = -1       # moe_dispatch_launch's return when an index was bad


def moe_dispatch(x: torch.Tensor, sort_idx: torch.Tensor,
                 gates: torch.Tensor) -> torch.Tensor:
    """out[s, :] = gates[s] · x[sort_idx[s], :], the gate rounded to x's
    type first; equal to ``plain`` bit for bit."""
    dev = x.device
    if dev.type != "cuda" or sort_idx.device != dev or gates.device != dev:
        raise ValueError("moe_dispatch kernel: all operands on one CUDA "
                         f"device, got {x.device}, {sort_idx.device}, "
                         f"{gates.device}")
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError("moe_dispatch kernel: x float32 or bfloat16 (t, d), "
                        f"got {x.dtype} {tuple(x.shape)}")
    if sort_idx.dtype != torch.int32 or gates.dtype != torch.float32:
        raise TypeError("moe_dispatch kernel: int32 indices and float32 "
                        f"gates, got {sort_idx.dtype}, {gates.dtype}")
    (slots,) = sort_idx.shape
    if gates.shape != (slots,):
        raise ValueError(f"moe_dispatch kernel: {slots} indices but gates "
                         f"{tuple(gates.shape)}")
    if not all(a.is_contiguous() for a in (x, sort_idx, gates)):
        raise ValueError("moe_dispatch kernel: contiguous operands")
    t, d = x.shape
    if d % 8 or x.data_ptr() % 16:
        raise ValueError("moe_dispatch kernel: d a multiple of 8 and x "
                         f"16-byte aligned, got d={d}")
    if max(slots, t, d) >= 2 ** 31 - 1:
        raise ValueError("moe_dispatch kernel: sizes beyond int32")
    out = torch.empty((slots, d), dtype=x.dtype, device=dev)
    if slots == 0 or d == 0:
        return out
    lib = build.library("moe_dispatch", _SIGNATURES)
    device, stream = build.device_and_stream(x)
    rc = lib.moe_dispatch_launch(
        x.data_ptr(), sort_idx.data_ptr(), gates.data_ptr(), out.data_ptr(),
        slots, t, d, _DTYPES[x.dtype], device, stream)
    if rc != _BAD_INDEX:
        build.check(rc, "moe_dispatch")
    moe_dispatch.launches += 1
    if rc == _BAD_INDEX:
        raise ValueError(f"moe_dispatch kernel: an index lies outside "
                         f"0..{t - 1}")
    return out


moe_dispatch.launches = 0
