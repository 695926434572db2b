"""Full-sequence GQA softmax attention on the card: the wrapper of
``csrc/flash_attention.cu`` (an online-softmax kernel in IEEE float32 FMAs;
the source says why and what bounds it).  It replaces the Pallas TPU kernel
``repro.kernels.flash_attention``; ``plain`` is its PyTorch twin.

q (B, Hq, S, D) and k, v (B, Hkv, S, D), all float32 or all bfloat16,
Hq a multiple of Hkv, D in {32, 64, 128}; any ragged S.  Each operand needs
unit stride in D only: the head-split views of the model go in as they are.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

plain = ref.flash_attention

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_launch": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.c_float, _I, _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """softmax(scale · q kᵀ [causal mask]) v per query head, with query
    head h reading KV head h // (Hq / Hkv); returned contiguous in q's
    type."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention kernel: q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel: q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} are not GQA-compatible")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: unit stride in D")
    if max(b, hq, s) >= 2 ** 31 - 1 or hq > 65535 or b > 65535:
        raise ValueError("flash_attention kernel: sizes beyond the grid")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    lib = build.library("flash_attention", _SIGNATURES)
    device, stream = build.device_and_stream(q)
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        s, d, ctypes.addressof(strides), float(scale), int(bool(causal)),
        _DTYPES[q.dtype], device, stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
