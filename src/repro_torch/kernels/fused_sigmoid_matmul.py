"""``sig(X · W)`` on the card: the wrapper of ``csrc/fused_sigmoid_matmul.cu``
(a tiled float32-FMA matmul with the sigmoid in its epilogue; no TF32).
It replaces the Pallas TPU kernel ``repro.kernels.fused_sigmoid_matmul``;
``plain`` is its PyTorch twin.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

plain = ref.fused_sigmoid_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fsm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_sigmoid_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sig(x @ w), accumulated in float32, returned in x's type."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("fused_sigmoid_matmul kernel: both operands on one "
                         f"CUDA device, got {x.device}, {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError("fused_sigmoid_matmul kernel: x and w both float32 "
                        f"or both bfloat16, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_sigmoid_matmul kernel: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_sigmoid_matmul kernel: contiguous operands")
    (m, k), n = x.shape, w.shape[1]
    if max(m, k, n) >= 2 ** 31 - 1:
        raise ValueError("fused_sigmoid_matmul kernel: sizes beyond int32")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = build.library("fused_sigmoid_matmul", _SIGNATURES)
    device, stream = build.device_and_stream(x)
    build.check(lib.fsm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               m, k, n, _DTYPES[x.dtype], device, stream),
                "fused_sigmoid_matmul")
    fused_sigmoid_matmul.launches += 1
    return out


fused_sigmoid_matmul.launches = 0
