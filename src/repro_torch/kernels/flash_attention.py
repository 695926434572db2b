"""Full-sequence GQA softmax attention on the card: the wrapper of two
kernels, picked by dtype, both on Hopper's tensor cores.  bfloat16
operands go to ``csrc/flash_attention_tc.cu`` (wgmma products, K/V tiles
by TMA into a two-stage mbarrier ring; float32 scores, P rounded to bf16
before P·V); float32 operands to ``csrc/flash_attention.cu`` (3xTF32: each
operand split into TF32 hi and lo parts, a·b taken as three wgmma products
summed in float32, which keeps float32 accuracy where one TF32 product
keeps three digits; a pre-pass splits K and V once into a scratch buffer
that this wrapper allocates, then TMA streams the parts).  The sources say
why and what bounds each.  Both replace the Pallas TPU kernel
``repro.kernels.flash_attention``; ``plain`` is their PyTorch twin.
``flash_attention_bwd`` is the gradient (``csrc/flash_attention_bwd.cu``,
also on wgmma + TMA, float32-grade in both types: bf16 splits P and dS into
two bf16 parts, float32 runs 3xTF32 on split copies in a scratch buffer
this wrapper allocates; plain twin ``plain_bwd``): the Pallas kernel has
none, and the JAX package differentiates its jnp twin.

q (B, Hq, S, D), k (B, Hkv, S, D) and v (B, Hkv, S, Dv), all float32 or
all bfloat16, Hq a multiple of Hkv, (D, Dv) in ``head_dims(dtype)``:
``HEAD_DIMS`` in both types (Dv = D, or MLA's D = 192 with Dv = 128,
among others; the JAX package's Zamba2 block is (80, 80), which both
kernels pad to whole slabs on chip: the sources say how), and in bf16
alone Zamba2-7B's shared attention, (224, 224), which the bf16 kernels
take in 64-key tiles with 256-column accumulators (the sources say why).
The float32 kernels stop at D = 192: (224, 224) in float32 raises the
error of any other pair they lack.  Any ragged S.  Each operand
needs unit stride in its last axis, and in bf16 what TMA needs besides: a
16-byte-aligned base and batch, head and sequence strides of whole 16-byte
units (``takes`` says whether a tensor qualifies; ``ops`` copies one that
does not).  So the head-split views of the model go in as they are.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs import tracer as obs
from . import build, ref

plain = ref.flash_attention

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float, _I]
#: dtype → (source, its C entry point, the arguments after ``_ARGS``: the
#: float32 library also takes its scratch)
_LIBS = {torch.float32: ("flash_attention", "flash_attention_launch",
                         [_P, _I, _P]),
         torch.bfloat16: ("flash_attention_tc", "flash_attention_tc_launch",
                          [_I, _P])}
#: the (D, Dv) pairs both kernels are built for: D in {32, 64, 128, 192},
#: Dv in {32, 64, 128}, Dv <= D; and (80, 80), the JAX package's Zamba2
HEAD_DIMS = tuple(sorted(
    [(d, dv) for d in (32, 64, 128, 192) for dv in (32, 64, 128) if dv <= d]
    + [(80, 80)]))
#: the pairs the bf16 kernels take besides: Zamba2-7B's shared attention
BF16_HEAD_DIMS = ((224, 224),)


def head_dims(dtype: torch.dtype) -> tuple:
    """The (D, Dv) pairs the kernels of ``dtype`` are built for."""
    return HEAD_DIMS + BF16_HEAD_DIMS if dtype == torch.bfloat16 \
        else HEAD_DIMS


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The batch, head and sequence strides the kernel reads, with an axis
    of extent 1 given its contiguous stride (it is never stepped along)."""
    return tuple(t.stride(i) if t.shape[i] > 1
                 else t.shape[i + 1:].numel() for i in range(3))


def scratch_numel(b: int, hkv: int, s: int, d: int, dv: int) -> int:
    """Floats of the float32 kernel's scratch: K and V^T, each in TF32 hi
    and lo parts, V^T's rows padded to whole groups of 8 keys."""
    return 2 * b * hkv * (s * d + dv * (-(-s // 8) * 8))


def bwd_scratch_numel(b: int, hq: int, hkv: int, s: int, d: int, dv: int,
                      dtype: torch.dtype) -> int:
    """Floats of the backward kernel's scratch: each query row's logsumexp
    and Δ (S rounded up to whole 64-row tiles) and, for float32 operands,
    the 3xTF32 split copies: q, k, v and dO in TF32 hi and lo rows, and qᵀ,
    dOᵀ and kᵀ in hi and lo, transposed, S rounded up to 8."""
    n = 2 * b * hq * (-(-s // 64) * 64)
    if dtype == torch.float32:
        s8 = -(-s // 8) * 8
        n += 2 * s * (b * hq + b * hkv) * (d + dv)
        n += 2 * s8 * (b * hq * (d + dv) + b * hkv * d)
    return n


def takes(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` in place: unit stride in its last
    axis and, in bf16 (TMA), a 16-byte-aligned base and strides."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides(t))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """softmax(scale · q kᵀ [causal mask]) v per query head, with query
    head h reading KV head h // (Hq / Hkv); returned (B, Hq, S, Dv)
    contiguous in q's type.  The scale defaults to D ** -0.5."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention kernel: q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _LIBS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel: q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} are not GQA-compatible")
    dv = v.shape[3]
    if (d, dv) not in head_dims(q.dtype):
        raise ValueError(f"flash_attention kernel: head dims (q/k {d}, v "
                         f"{dv}) not in {head_dims(q.dtype)} ({q.dtype})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: unit stride in D")
    if not all(takes(t) for t in (q, k, v)):
        raise ValueError("flash_attention kernel: bf16 operands need a "
                         "16-byte-aligned base and batch, head and sequence "
                         "strides of whole 16-byte units (TMA)")
    if max(b, hq, s) >= 2 ** 31 - 1 or hq > 65535 or b > 65535:
        raise ValueError("flash_attention kernel: sizes beyond the grid")
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    strides = (ctypes.c_longlong * 9)(*(st for t in (q, k, v)
                                        for st in _strides(t)))
    source, entry, tail = _LIBS[q.dtype]
    with obs.span("kernels.flash_attention", shape=(b, hq, hkv, s, d, dv),
                  route=source):
        lib = build.library(source, {entry: _ARGS + tail})
        device, stream = build.device_and_stream(q)
        # the float32 kernel's split K and V^T; freed after the call, which
        # is safe on the stream that the kernel runs on
        scratch = [torch.empty(scratch_numel(b, hkv, s, d, dv),
                               dtype=torch.float32, device=dev)
                   ] if q.dtype == torch.float32 else []
        with obs.span("kernels.launch"):
            rc = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, s, d, dv, ctypes.addressof(strides), float(scale),
                int(bool(causal)), *(t.data_ptr() for t in scratch), device,
                stream)
        build.check(rc, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0

plain_bwd = ref.flash_attention_bwd
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
             ctypes.c_float, _I, _I, _P, _I, _P]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output's
    gradient ``do`` (B, Hq, S, Dv): the kernels of
    ``csrc/flash_attention_bwd.cu`` on wgmma (dQ a query tile, after a
    first walk that writes each query row's logsumexp and Δ = Σ P·dP into a
    scratch this wrapper allocates; then dV and dK a key tile; float32
    first splits its operands into the same scratch).  All four operands
    float32 or all bf16, on one CUDA device, with unit stride in the last
    axis and, in bf16, what TMA needs besides (``takes``); batch, head and
    sequence strides are read as they are.  The gradients come back
    contiguous in the operands' type, the derivative of ``plain(...,
    bf16_scores=False)``; its plain twin is ``plain_bwd``."""
    ops_ = (q, k, v, do)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ops_):
        raise ValueError("flash_attention_bwd kernel: q, k, v, do on one "
                         "CUDA device, got "
                         f"{[str(t.device) for t in ops_]}")
    if q.dtype not in _LIBS or any(t.dtype != q.dtype for t in ops_):
        raise TypeError("flash_attention_bwd kernel: q, k, v, do all "
                        "float32 or all bfloat16, got "
                        f"{[t.dtype for t in ops_]}")
    if any(t.dim() != 4 for t in ops_) or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention_bwd kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"flash_attention_bwd kernel: q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)} are not GQA-compatible")
    if do.shape != (b, hq, s, dv):
        raise ValueError(f"flash_attention_bwd kernel: do {tuple(do.shape)}"
                         f", expected {(b, hq, s, dv)}")
    if (d, dv) not in head_dims(q.dtype):
        raise ValueError(f"flash_attention_bwd kernel: head dims (q/k {d}, "
                         f"v {dv}) not in {head_dims(q.dtype)} ({q.dtype})")
    if any(t.stride(-1) != 1 for t in ops_):
        raise ValueError("flash_attention_bwd kernel: unit stride in D")
    if not all(takes(t) for t in ops_):
        raise ValueError("flash_attention_bwd kernel: bf16 operands need a "
                         "16-byte-aligned base and batch, head and sequence "
                         "strides of whole 16-byte units (TMA)")
    if b * hq > 65535:
        raise ValueError("flash_attention_bwd kernel: sizes beyond the grid")
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=q.dtype, device=dev)
    dv_ = torch.empty(v.shape, dtype=q.dtype, device=dev)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv_.zero_()
    if scale is None:
        scale = d ** -0.5
    strides = (ctypes.c_longlong * 12)(*(st for t in ops_
                                         for st in _strides(t)))
    with obs.span("kernels.flash_attention_bwd",
                  shape=(b, hq, hkv, s, d, dv)):
        lib = build.library("flash_attention_bwd",
                            {"flash_attention_bwd_launch": _BWD_ARGS})
        device, stream = build.device_and_stream(q)
        # the logsumexp and Delta of every query row, and float32's split
        # copies; freed after the call, which is safe on the stream that
        # the kernels run on
        scratch = torch.empty(bwd_scratch_numel(b, hq, hkv, s, d, dv,
                                                q.dtype),
                              dtype=torch.float32, device=dev)
        with obs.span("kernels.launch"):
            rc = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), b, hq,
                hkv, s, d, dv, ctypes.addressof(strides), float(scale),
                int(bool(causal)), int(q.dtype == torch.bfloat16),
                scratch.data_ptr(), device, stream)
        build.check(rc, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    return dq, dk, dv_


flash_attention_bwd.launches = 0
