"""One dot product a tuple on the card: the wrapper of ``csrc/tuple_dot.cu``
(one warp a tuple, a fixed-order warp reduction; the source says what
bounds it).  It is the gradient of ``relational_matmul`` with respect to
its values and of ``moe_dispatch`` with respect to its gates, which the
JAX package gets from ``jax.grad``; no Pallas kernel computes it.
``plain`` is its PyTorch twin.  a and b are float32 or bf16, each read in
its own type; the sums are float32.  A tuple whose row is ``a.shape[0]``
(the padding) gives 0; a col id outside 0..b.shape[0]-1 gives a NaN (the
kernel reads nothing out of bounds and waits for nothing: its callers pass
ids that their forward kernels checked).
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import tracer as obs
from . import build, ref

plain = ref.tuple_dot

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tuple_dot_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tuple_dot(a: torch.Tensor, rows: torch.Tensor, b: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """out (nnz,) float32: out[t] = a[rows[t]] · b[cols[t]]; two calls give
    the same bits."""
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev for t in (a, rows, cols)):
        raise ValueError("tuple_dot kernel: all operands on one CUDA device, "
                         f"got {a.device}, {rows.device}, {b.device}, "
                         f"{cols.device}")
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise TypeError("tuple_dot kernel: a and b float32 or bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("tuple_dot kernel: int32 row/col ids")
    nnz = rows.shape[0]
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]
            or rows.dim() != 1 or cols.shape != (nnz,)):
        raise ValueError("tuple_dot kernel: a (ma, d), b (mb, d), ids (nnz,),"
                         f" got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}")
    if not all(t.is_contiguous() for t in (a, rows, b, cols)):
        raise ValueError("tuple_dot kernel: contiguous operands")
    d = a.shape[1]
    if d % 8 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("tuple_dot kernel: d a multiple of 8 and a, b "
                         f"16-byte aligned, got d={d}")
    if max(nnz, a.shape[0], b.shape[0], d) >= 2 ** 31 - 1:
        raise ValueError("tuple_dot kernel: sizes beyond int32")
    out = torch.empty(nnz, dtype=torch.float32, device=dev)
    if nnz == 0:
        return out
    with obs.span("kernels.tuple_dot", shape=(a.shape[0], b.shape[0], d),
                  tuples=nnz):
        lib = build.library("tuple_dot", _SIGNATURES)
        device, stream = build.device_and_stream(b)
        with obs.span("kernels.launch"):
            rc = lib.tuple_dot_launch(
                a.data_ptr(), rows.data_ptr(), b.data_ptr(), cols.data_ptr(),
                out.data_ptr(), nnz, a.shape[0], b.shape[0], d,
                _DTYPES[a.dtype], _DTYPES[b.dtype], device, stream)
        build.check(rc, "tuple_dot")
        tuple_dot.launches += 1
    return out


tuple_dot.launches = 0
