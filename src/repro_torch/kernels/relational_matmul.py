"""The relational engine's join + group-by matmul on the card: the wrapper
of ``csrc/relational_matmul.cu`` (a sorted-segment reduction; the source
says why and what bounds it).  It replaces the Pallas TPU kernel
``repro.kernels.relational_matmul``; ``plain`` is its PyTorch twin.

The kernel's second pass needs the relation sorted — ``row_ids``
non-decreasing with the padding tuples (``row_ids == m``) last.  Every
RelTensor the engines build is (``from_dense``, ``transpose``'s re-sort,
``one_hot``), but the wrapper, like ``plain``, takes any order: the first
pass checks the relation into a status word, which the host reads once per
call.  If the rows are only out of order, the wrapper sorts the tuples by
row id on the device (stably, so the padding stays last) and runs both
passes on the sorted copy.  A row id outside 0..m or a col id outside
0..k-1 raises ``ValueError`` before the second pass runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

plain = ref.relational_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "relmm_offsets": [_P, _P, _I, _I, _I, _P, _P, _I, _P],
    "relmm_spmm": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}
_INT32_MAX = 2 ** 31 - 1
#: bits of the kernel's status word
_FAULTS = ((1, "a row id outside 0..m or a col id outside 0..k-1"),
           (2, "row_ids not sorted with the padding (== m) last"))
_UNSORTED = 2


def relational_matmul(row_ids: torch.Tensor, col_ids: torch.Tensor,
                      vals: torch.Tensor, b: torch.Tensor, m: int
                      ) -> torch.Tensor:
    """out (m, n) float32 = Σ over each row's segment of vals · b[col]."""
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (row_ids, col_ids, vals)):
        raise ValueError("relational_matmul kernel: all operands on one "
                         f"CUDA device, got {row_ids.device}, {col_ids.device}"
                         f", {vals.device}, {b.device}")
    if row_ids.dtype != torch.int32 or col_ids.dtype != torch.int32:
        raise TypeError("relational_matmul kernel: int32 row/col ids")
    if vals.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("relational_matmul kernel: float32 vals and b, got "
                        f"{vals.dtype}, {b.dtype}")
    nnz = row_ids.shape[0]
    if (row_ids.dim() != 1 or col_ids.shape != (nnz,)
            or vals.shape != (nnz,) or b.dim() != 2):
        raise ValueError("relational_matmul kernel: ids/vals (nnz,), b (k, n)")
    if not all(t.is_contiguous() for t in (row_ids, col_ids, vals, b)):
        raise ValueError("relational_matmul kernel: contiguous operands")
    k, n = b.shape
    if max(nnz, m, k, n) >= _INT32_MAX:
        raise ValueError("relational_matmul kernel: sizes beyond int32")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = build.library("relational_matmul", _SIGNATURES)
    device, stream = build.device_and_stream(b)
    offsets = torch.empty(m + 1, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    build.check(lib.relmm_offsets(row_ids.data_ptr(), col_ids.data_ptr(),
                                  nnz, m, k, offsets.data_ptr(),
                                  err.data_ptr(), device, stream),
                "relational_matmul/segment_offsets")
    bad = int(err.item())
    if bad == _UNSORTED:
        order = torch.sort(row_ids, stable=True).indices
        row_ids, col_ids, vals = row_ids[order], col_ids[order], vals[order]
        err.zero_()
        build.check(lib.relmm_offsets(row_ids.data_ptr(), col_ids.data_ptr(),
                                      nnz, m, k, offsets.data_ptr(),
                                      err.data_ptr(), device, stream),
                    "relational_matmul/segment_offsets")
        bad = int(err.item())
    if bad:
        reasons = [why for bit, why in _FAULTS if bad & bit]
        raise ValueError("relational_matmul kernel: " + "; ".join(reasons))
    build.check(lib.relmm_spmm(offsets.data_ptr(), col_ids.data_ptr(),
                               vals.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, device, stream),
                "relational_matmul/segment_spmm")
    relational_matmul.launches += 1
    return out


relational_matmul.launches = 0
