"""``onehot(ids) · table`` on the card: the wrapper of ``csrc/onehot_embed.cu``
(a row gather with the widest word the row allows, up to 16 bytes).  It
replaces the Pallas TPU kernel ``repro.kernels.onehot_embed``; ``plain`` is
its PyTorch twin.  An id outside 0..v-1 raises ``IndexError`` from the call
(the kernel writes a zero row for it and raises the device's status flag;
the C launcher waits for this kernel alone, reads the flag from pinned host
memory and clears it).
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import tracer as obs
from . import build, ref

plain = ref.onehot_embed

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"onehot_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}
_BAD_ID = -1          # onehot_launch's return when an id was out of range


def onehot_embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[t, :] = table[ids[t], :], exact."""
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError("onehot_embed kernel: both operands on one CUDA "
                         f"device, got {ids.device}, {table.device}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError("onehot_embed kernel: ids int32 (t,)")
    if table.dtype not in (torch.float32, torch.bfloat16) or table.dim() != 2:
        raise TypeError("onehot_embed kernel: table float32 or bfloat16 "
                        f"(v, d), got {table.dtype} {tuple(table.shape)}")
    if not (ids.is_contiguous() and table.is_contiguous()):
        raise ValueError("onehot_embed kernel: contiguous operands")
    (t,), (v, d) = ids.shape, table.shape
    row_bytes = d * table.element_size()
    if max(t, v, row_bytes) >= 2 ** 31 - 1:
        raise ValueError("onehot_embed kernel: sizes beyond int32")
    out = torch.empty((t, d), dtype=table.dtype, device=table.device)
    if t == 0 or d == 0:
        return out
    word = next(w for w in (16, 8, 4, 2)
                if not (row_bytes % w or table.data_ptr() % w
                        or out.data_ptr() % w))
    with obs.span("kernels.onehot_embed", shape=(t, v, d)):
        lib = build.library("onehot_embed", _SIGNATURES)
        device, stream = build.device_and_stream(table)
        # the launcher waits for the kernel and reads its status flag
        with obs.span("kernels.status_wait"):
            rc = lib.onehot_launch(ids.data_ptr(), table.data_ptr(),
                                   out.data_ptr(), t, v, row_bytes, word,
                                   device, stream)
        if rc != _BAD_ID:
            build.check(rc, "onehot_embed")
        onehot_embed.launches += 1
    if rc == _BAD_ID:
        raise IndexError(f"onehot_embed kernel: an id lies outside 0..{v - 1}")
    return out


onehot_embed.launches = 0
