"""RWKV-6 time-mix recurrence on the card: the wrappers of
``csrc/rwkv6_scan.cu`` (one block per row of state, the time loop inside
it, r/k/v/w through a cp.async ring in shared memory, the u term factored
into one O(N) sum a step so a cell costs three FP instructions, IEEE
float32 FMAs; the source says why and what bounds it).  It replaces the
Pallas TPU kernel ``repro.kernels.rwkv6_scan``; ``plain`` is its PyTorch
twin.  And of its gradient, ``csrc/rwkv6_scan_bwd.cu``, which the JAX
package gets from ``jax.grad`` of a ``lax.scan``: chunked and division-free,
its products on the tensor cores in 3xTF32 (a first launch walks the
chunks of 64 steps once for the state before each and G after it, into a
scratch this wrapper allocates; a second takes every chunk alone, in
sub-chunks of 16; a third sums du over the chunks).  ``plain_bwd`` is its
oracle, the sequential reverse loop; ``ref.rwkv6_scan_bwd_chunked`` is the
twin of its algebra.

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

from ..obs import tracer as obs
from . import build, ref

plain = ref.rwkv6_scan
plain_bwd = ref.rwkv6_scan_bwd

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rwkv6_scan_launch": [_P] * 8 + [_I] * 4 + [_P, _I, _P]}
_BWD_SIGNATURES = {"rwkv6_scan_bwd_launch": [_P] * 15 + [_I] * 4
                   + [_P, _I, _P],
                   "rwkv6_scan_bwd_scratch": ([_I] * 3, ctypes.c_longlong)}
HEAD_DIMS = (16, 32, 64)


def _check(what: str, operands, names: str):
    """The checks both kernels share: one CUDA device, float32, r's shape
    for k, v, w (and do), u and s0 to match, N in HEAD_DIMS, S ≥ 1, unit
    stride in N.  Returns (lead, s, n)."""
    r = operands[0]
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError(f"{what} kernel: {names} on one CUDA device, got "
                         f"{[str(t.device) for t in operands]}")
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"{what} kernel: all operands float32, got "
                        f"{[str(t.dtype) for t in operands]}")
    seqs = operands[:4] + operands[6:7]
    if r.dim() not in (3, 4) or any(t.shape != r.shape for t in seqs):
        raise ValueError(f"{what} kernel: r, k, v, w"
                         f"{', do' * (len(seqs) > 4)} of one shape, got "
                         f"{[tuple(t.shape) for t in seqs]}")
    *lead, s, n = r.shape
    u, s0 = operands[4], operands[5]
    if u.shape != (*lead, n) or s0.shape != (*lead, n, n):
        raise ValueError(f"{what} kernel: r {tuple(r.shape)} takes u "
                         f"{(*lead, n)} and s0 {(*lead, n, n)}, got "
                         f"{tuple(u.shape)} and {tuple(s0.shape)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {n} not in {HEAD_DIMS}")
    if s < 1:
        raise ValueError(f"{what} kernel: needs S >= 1")
    if any(t.stride(-1) != 1 for t in seqs + (u,)) \
            or not s0.is_contiguous():
        raise ValueError(f"{what} kernel: unit stride in N, s0 contiguous")
    if s0.numel() // (n * n) >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"{what} kernel: sizes beyond the grid")
    return lead, s, n


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (o, s_fin): o in r's shape (and, where r is dense, its memory
    layout), s_fin contiguous in s0's shape."""
    _check("rwkv6_scan", (r, k, v, w, u, s0), "r, k, v, w, u, s0")
    *lead, s, n = r.shape
    rows = s0.numel() // (n * n)
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
    with obs.span("kernels.rwkv6_scan", shape=(batch, heads, s, n)):
        lib = build.library("rwkv6_scan", _SIGNATURES)
        device, stream = build.device_and_stream(r)
        with obs.span("kernels.launch"):
            rc = lib.rwkv6_scan_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_fin.data_ptr(),
                batch, heads, s, n, ctypes.addressof(strides), device, stream)
        build.check(rc, "rwkv6_scan")
        rwkv6_scan.launches += 1
    return o, s_fin


rwkv6_scan.launches = 0


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   do: torch.Tensor, ds_fin: torch.Tensor | None = None,
                   want_ds0: bool = True):
    """(dr, dk, dv, dw, du, ds0) of ``rwkv6_scan(r, k, v, w, u, s0)`` for
    the output gradient ``do`` (r's shape, unit stride in N) and the final
    state's ``ds_fin`` (s0's shape, or None for 0).  dr, dk, dv and dw come
    in their operand's shape and, where it is dense, its memory layout (the
    model's (B, S, H, N) memory: the transposes' backward copies nothing);
    du per row of state, u's shape (contiguous: autograd sums it over u's
    expand); ds0 contiguous in s0's shape, or None unless ``want_ds0``.
    Three kernel launches a call, no atomics: two calls give equal bits."""
    _check("rwkv6_scan_bwd", (r, k, v, w, u, s0, do),
           "r, k, v, w, u, s0, do")
    *lead, s, n = r.shape
    if ds_fin is not None:
        if ds_fin.shape != s0.shape or ds_fin.dtype != torch.float32 \
                or ds_fin.device != r.device:
            raise ValueError("rwkv6_scan_bwd kernel: ds_fin float32 on r's "
                             f"device in s0's shape {tuple(s0.shape)}, got "
                             f"{ds_fin.dtype}{tuple(ds_fin.shape)}")
        ds_fin = ds_fin.contiguous()
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.empty((*lead, n), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0) if want_ds0 else None
    rows = s0.numel() // (n * n)
    if rows == 0:
        return dr, dk, dv, dw, du, ds0
    as4 = (lambda t: t) if r.dim() == 4 else (lambda t: t.unsqueeze(0))
    seqs = [as4(t) for t in (r, k, v, w, do, dr, dk, dv, dw)]
    batch, heads = seqs[0].shape[:2]
    strides = (ctypes.c_longlong * 29)(
        *(t.stride(i) for t in seqs for i in range(3)),
        *(as4(u).stride(i) for i in range(2)))
    ptr = lambda t: None if t is None else t.data_ptr()
    with obs.span("kernels.rwkv6_scan_bwd", shape=(batch, heads, s, n)):
        lib = build.library("rwkv6_scan_bwd", _BWD_SIGNATURES)
        # the state before and G after every chunk, and du's sum in each
        scratch = torch.empty(lib.rwkv6_scan_bwd_scratch(rows, s, n),
                              dtype=torch.uint8, device=r.device)
        device, stream = build.device_and_stream(r)
        with obs.span("kernels.launch"):
            rc = lib.rwkv6_scan_bwd_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), do.data_ptr(), ptr(ds_fin),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                du.data_ptr(), ptr(ds0), scratch.data_ptr(), batch, heads, s,
                n, ctypes.addressof(strides), device, stream)
        build.check(rc, "rwkv6_scan_bwd")
        rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


rwkv6_scan_bwd.launches = 0
