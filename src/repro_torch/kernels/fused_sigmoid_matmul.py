"""``sig(X · W)`` on the card: the wrapper of ``csrc/fused_sigmoid_matmul.cu``
(a float32-FMA matmul with the sigmoid in its epilogue; no TF32).  It
replaces the Pallas TPU kernel ``repro.kernels.fused_sigmoid_matmul``;
``plain`` is its PyTorch twin.

The kernel has two tile instances, and ``instance`` picks one from the
shape: ``wide`` (40 × 40 outputs a block) and ``narrow`` (16 × 16, for
up to 16 columns: the model's output layer, n = 10).  The source says why.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import tracer as obs
from . import build, ref

plain = ref.fused_sigmoid_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fsm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: tile instance → (its id in the C launcher, block rows, block columns)
TILES = {"wide": (0, 40, 40), "narrow": (1, 16, 16)}


def instance(m: int, k: int, n: int) -> str:
    """The tile instance for an (m, k) · (k, n) product: ``narrow`` keeps
    up to 16 columns in one block and spreads m over the blocks, ``wide``
    takes the rest."""
    return "narrow" if n <= TILES["narrow"][2] else "wide"


def blocks(m: int, k: int, n: int) -> int:
    """The blocks the kernel launches for an (m, k) · (k, n) product."""
    _, bm, bn = TILES[instance(m, k, n)]
    return -(-m // bm) * -(-n // bn)


def chunks(x: torch.Tensor, w: torch.Tensor) -> int:
    """Which operands go to shared memory in 16-byte copies (bit 0: x,
    bit 1: w): float32 rows that are whole 16-byte units from a 16-byte
    aligned base.  The rest go 4 bytes at a time; bf16 (converted on the
    way) always does."""
    if x.dtype != torch.float32:
        return 0
    (_, k), n = x.shape, w.shape[1]
    return (int(k % 4 == 0 and x.data_ptr() % 16 == 0)
            | int(n % 4 == 0 and w.data_ptr() % 16 == 0) << 1)


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
    tile = instance(m, k, n)
    with obs.span("kernels.fused_sigmoid_matmul", shape=(m, k, n),
                  route=tile):
        lib = build.library("fused_sigmoid_matmul", _SIGNATURES)
        device, stream = build.device_and_stream(x)
        with obs.span("kernels.launch"):
            rc = lib.fsm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                m, k, n, _DTYPES[x.dtype], TILES[tile][0],
                                chunks(x, w), device, stream)
        build.check(rc, "fused_sigmoid_matmul")
        fused_sigmoid_matmul.launches += 1
    return out


fused_sigmoid_matmul.launches = 0
