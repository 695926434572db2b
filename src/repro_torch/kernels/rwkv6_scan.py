"""RWKV-6 time-mix recurrence on the card: the wrapper of
``csrc/rwkv6_scan.cu`` (one block per row of state, the time loop inside
it, r/k/v/w through a cp.async ring in shared memory, the u term factored
into one O(N) sum a step so a cell costs three FP instructions, IEEE
float32 FMAs; the source says why and what bounds it).  It replaces the
Pallas TPU kernel ``repro.kernels.rwkv6_scan``; ``plain`` is its PyTorch
twin.

    o_t = r_t·(S + diag(u) k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

r, k, v, w: (BH, S, N) as the JAX kernel takes them, or (B, H, S, N); u:
(BH, N) or (B, H, N); s0: (BH, N, N) or (B, H, N, N).  All float32,
N in {16, 32, 64}, any S ≥ 1.  r, k, v, w and u need unit stride in N
only: the model's head-split views of its (B, S, H, N) projections, and u
expanded over the batch, go in as they are.  s0 is only read; s_fin is a
new tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

plain = ref.rwkv6_scan

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv6_scan_launch": [_P] * 8 + [_I] * 4 + [_P, _I, _P]}
HEAD_DIMS = (16, 32, 64)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (o, s_fin): o in r's shape (and, where r is dense, its memory
    layout), s_fin contiguous in s0's shape."""
    operands = (r, k, v, w, u, s0)
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError("rwkv6_scan kernel: r, k, v, w, u, s0 on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError("rwkv6_scan kernel: all operands float32, got "
                        f"{[str(t.dtype) for t in operands]}")
    if r.dim() not in (3, 4) or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_scan kernel: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}")
    *lead, s, n = r.shape
    if u.shape != (*lead, n) or s0.shape != (*lead, n, n):
        raise ValueError(f"rwkv6_scan kernel: r {tuple(r.shape)} takes u "
                         f"{(*lead, n)} and s0 {(*lead, n, n)}, got "
                         f"{tuple(u.shape)} and {tuple(s0.shape)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel: head dim {n} not in "
                         f"{HEAD_DIMS}")
    if s < 1:
        raise ValueError("rwkv6_scan kernel: needs S >= 1")
    if any(t.stride(-1) != 1 for t in operands[:5]) \
            or not s0.is_contiguous():
        raise ValueError("rwkv6_scan kernel: unit stride in N, s0 "
                         "contiguous")
    rows = s0.numel() // (n * n)
    if rows >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError("rwkv6_scan kernel: sizes beyond the grid")
    o = torch.empty_like(r)
    s_fin = torch.empty_like(s0, memory_format=torch.contiguous_format)
    if rows == 0:
        return o, s_fin
    # a (BH, S, N) call is a (1, BH, S, N) one: b is always 0
    as4 = (lambda t: t) if r.dim() == 4 else (lambda t: t.unsqueeze(0))
    seqs = [as4(t) for t in (r, k, v, w, o)]
    batch, heads = seqs[0].shape[:2]
    strides = (ctypes.c_longlong * 17)(
        *(t.stride(i) for t in seqs for i in range(3)),
        *(as4(u).stride(i) for i in range(2)))
    lib = build.library("rwkv6_scan", _SIGNATURES)
    device, stream = build.device_and_stream(r)
    build.check(lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(), batch, heads, s, n,
        ctypes.addressof(strides), device, stream), "rwkv6_scan")
    rwkv6_scan.launches += 1
    return o, s_fin


rwkv6_scan.launches = 0
