"""The relational engine's join + group-by matmul on the card: the wrapper
of ``csrc/relational_matmul.cu`` (a sorted-segment reduction; the source
says why and what bounds it).  It replaces the Pallas TPU kernel
``repro.kernels.relational_matmul``; ``plain`` is its PyTorch twin.  ``b``
is float32 or bf16: a bf16 value is widened to float32 exactly and the sums
are float32, as the JAX kernel computes them, so a bf16 ``b`` gives the
bits of ``b.float()``.

The kernel's second pass needs the relation sorted — ``row_ids``
non-decreasing with the padding tuples (``row_ids == m``) last.  Every
RelTensor the engines build is (``from_dense``, ``transpose``'s re-sort,
``one_hot``), but the wrapper, like ``plain``, takes any order: the first
pass checks the relation into two status flags in pinned host memory, which
its C launcher reads after waiting for that pass alone (one host wait a
call).  If the rows are only out of order, the wrapper sorts the tuples by
row id on the device (stably, so the padding stays last) and runs both
passes on the sorted copy.  A row id outside 0..m or a col id outside
0..k-1 raises ``ValueError`` before the second pass runs.

The second pass has two schedules, which ``schedule`` picks from the shape:
``slab`` (a k × tile_n slab of b in shared memory; the MLP's products with
long segments) and ``stream`` (b's rows read from device memory as the
tuples name them; the MoE combine, and segments of a few tuples).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..obs import tracer as obs
from . import build, ref

plain = ref.relational_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "relmm_offsets": [_P, _P, _I, _I, _I, _P, _I, _P],
    "relmm_slab": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "relmm_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1
#: bits of the first pass's status flags
_FAULTS = ((1, "a row id outside 0..m or a col id outside 0..k-1"),
           (2, "row_ids not sorted with the padding (== m) last"))
_UNSORTED = 2

#: shared memory a block can have on an H100, and what an SM has
SMEM_LIMIT = 232_448
SMEM_PER_SM = 233_472
SLAB_WARPS = 16
#: each slab warp's staged tuples (8 bytes each), beside the slab
STAGE_BYTES = SLAB_WARPS * 128 * 8
SLAB_WIDTHS = (4, 8, 16, 32, 64, 128, 256)
#: the shortest average segment a slab is used for: one tuple a lane
SLAB_MIN_SEGMENT = 32
STREAM_COLS = 512
STREAM_WARPS = 8
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How the second pass runs: ``kind`` ``"slab"`` (schedule (a)) or
    ``"stream"`` ((b)); ``tile_n`` the columns of b a block (slab) or a
    warp (stream) sums; ``blocks`` launched; for a slab, its shared memory
    ``smem`` (bytes a block), ``rows_per_block`` and ``split``, the warps
    that share one row's segment; for a stream, ``vector``, b's values a
    16-byte load reads."""
    kind: str
    tile_n: int
    blocks: int
    smem: int = 0
    rows_per_block: int = 0
    split: int = 1
    vector: int = 0


def _slab_width(k: int, n: int) -> int | None:
    """The slab's width: the narrowest of ``SLAB_WIDTHS`` that holds n
    columns, at most the widest whose k × width float32 slab fits beside
    the staged tuples; None where not even 4 columns fit."""
    fits = [w for w in SLAB_WIDTHS if k * w * 4 + STAGE_BYTES <= SMEM_LIMIT]
    if not fits:
        return None
    return min(max(fits), next((w for w in SLAB_WIDTHS if w >= n),
                               SLAB_WIDTHS[-1]))


def schedule(m: int, k: int, n: int, nnz: int, dtype: torch.dtype,
             sms: int = H100_SMS) -> Schedule:
    """The second pass's schedule for an (m × k) relation of ``nnz``
    tuples times a (k, n) ``b`` of ``dtype``, on a card of ``sms`` SMs.

    ``slab`` where a k × tile_n slab fits in shared memory, the tuples
    are at least k (each slab row is used once a block on average) and
    the rows' segments average at least ``SLAB_MIN_SEGMENT`` tuples (a
    shorter one leaves the block's fixed work unpaid: the slab's fill,
    the staging, the reduction over groups), else ``stream``.  The slab
    is float32 whatever b's type, so the choice, and with it the order of
    every sum, is the same for bf16 and float32 b; ``dtype`` sets only
    how many values a stream's 16-byte load reads.  A slab grid fills the
    SMs: ``rows_per_block`` shares the rows among as many blocks per
    column tile as the SMs hold at once, and ``split`` warps share a row
    where the block has fewer rows than warps or the segments run long
    (256 tuples a warp or more)."""
    width = _slab_width(k, n)
    if (width is not None and m > 0 and nnz >= k
            and nnz >= SLAB_MIN_SEGMENT * m and -(-n // width) < 2 ** 16):
        tiles = -(-n // width)
        smem = k * width * 4 + STAGE_BYTES
        per_sm = min(2048 // (32 * SLAB_WARPS), SMEM_PER_SM // (smem + 1024))
        row_blocks = max(1, sms * per_sm // tiles)
        rows_per_block = -(-m // row_blocks)
        by_length = max(1, nnz // m // 256)
        split = min(SLAB_WARPS, max(SLAB_WARPS // rows_per_block, by_length))
        split = 1 << (split.bit_length() - 1)            # a power of two
        return Schedule("slab", width, tiles * -(-m // rows_per_block),
                        smem, rows_per_block, split)
    return Schedule("stream", STREAM_COLS,
                    -(-m // STREAM_WARPS) * -(-n // STREAM_COLS),
                    vector=16 // dtype.itemsize)


def relational_matmul(row_ids: torch.Tensor, col_ids: torch.Tensor,
                      vals: torch.Tensor, b: torch.Tensor, m: int
                      ) -> torch.Tensor:
    """out (m, n) float32 = Σ over each row's segment of vals · b[col], b
    float32 or bf16."""
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (row_ids, col_ids, vals)):
        raise ValueError("relational_matmul kernel: all operands on one "
                         f"CUDA device, got {row_ids.device}, {col_ids.device}"
                         f", {vals.device}, {b.device}")
    if row_ids.dtype != torch.int32 or col_ids.dtype != torch.int32:
        raise TypeError("relational_matmul kernel: int32 row/col ids")
    if vals.dtype != torch.float32 or b.dtype not in _DTYPES:
        raise TypeError("relational_matmul kernel: float32 vals and float32 "
                        f"or bf16 b, got {vals.dtype}, {b.dtype}")
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
    with obs.span("kernels.relational_matmul", shape=(m, k, n),
                  tuples=nnz) as sp:
        lib = build.library("relational_matmul", _SIGNATURES)
        device, stream = build.device_and_stream(b)
        offsets = torch.empty(m + 1, dtype=torch.int32, device=dev)

        def first_pass() -> int:
            with obs.span("kernels.status_wait"):
                rc = lib.relmm_offsets(row_ids.data_ptr(), col_ids.data_ptr(),
                                       nnz, m, k, offsets.data_ptr(), device,
                                       stream)
            if rc > 0:
                build.check(rc, "relational_matmul/segment_offsets")
            return -rc

        bad = first_pass()
        resorted = bad == _UNSORTED
        if resorted:
            order = torch.sort(row_ids, stable=True).indices
            row_ids, col_ids, vals = (row_ids[order], col_ids[order],
                                      vals[order])
            bad = first_pass()
        if bad:
            reasons = [why for bit, why in _FAULTS if bad & bit]
            raise ValueError("relational_matmul kernel: "
                             + "; ".join(reasons))
        plan = schedule(m, k, n, nnz, b.dtype, _sms(dev))
        sp.set(route=plan.kind, resorted=resorted)
        ptrs = (offsets.data_ptr(), col_ids.data_ptr(), vals.data_ptr(),
                b.data_ptr(), out.data_ptr())
        with obs.span("kernels.launch"):
            if plan.kind == "slab":
                rc = lib.relmm_slab(*ptrs, m, k, n, _DTYPES[b.dtype],
                                    plan.tile_n, plan.rows_per_block,
                                    plan.split, device, stream)
            else:
                vec = n % plan.vector == 0 and b.data_ptr() % 16 == 0
                rc = lib.relmm_stream(*ptrs, m, n, _DTYPES[b.dtype], int(vec),
                                      device, stream)
        build.check(rc, f"relational_matmul/{plan.kind}_spmm")
        relational_matmul.launches += 1
    return out


relational_matmul.launches = 0


@functools.cache
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
