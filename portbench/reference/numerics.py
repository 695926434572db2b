"""The precisions a reference computes its products in: the one its
configuration states, and the next one below it, which makes the control
(TF32 below float32, fp8 below bf16).  Lower precisions are emulated by
rounding the operands, then multiplying exactly and summing in float32,
as the tensor cores do, so that the control runs alike on any device."""
from __future__ import annotations

import contextlib

import torch

#: float32 with TF32 off, float64, bf16, and the controls below them
PRECISIONS = ("float64", "float32", "tf32", "bf16", "fp8")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 type (e4m3 by default, e5m2 for gradients)
    under one per-tensor power-of-two scale, the largest that keeps the
    tensor's largest magnitude within the type's range, as bf16, which
    holds every such value exactly.  Under autograd the rounding passes
    the gradient through unchanged."""
    xd = x.detach()
    amax = xd.abs().amax().float().clamp_min(1e-30)
    top = torch.finfo(dtype).max
    scale = torch.exp2(torch.floor(torch.log2(top / amax)))
    low = ((xd.float() * scale).to(dtype).to(torch.bfloat16)
           / scale.to(torch.bfloat16))
    return _Rounded.apply(x, low) if x.requires_grad else low


class _Rounded(torch.autograd.Function):
    """``low`` forward, the gradient to ``x`` unchanged backward."""

    @staticmethod
    def forward(ctx, x, low):
        ctx.dtype = x.dtype
        return low

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _Fp8Product(torch.autograd.Function):
    """a @ b as fp8 training computes it: forward from e4m3 operands; the
    backward's two products from the saved e4m3 operands and the incoming
    gradient in e5m2; every sum in float32, every result bf16.  a is
    (..., k) against a (k, n) b, or both batched alike."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8(a.detach()), fp8(b.detach())
        ctx.save_for_backward(a8, b8)
        ctx.dtypes = (a.dtype, b.dtype)
        return a8 @ b8

    @staticmethod
    def backward(ctx, grad):
        a8, b8 = ctx.saved_tensors
        g8 = fp8(grad.detach(), torch.float8_e5m2)
        da = g8 @ b8.transpose(-1, -2)
        if b8.dim() == 2:
            db = (a8.reshape(-1, a8.shape[-1]).T
                  @ g8.reshape(-1, g8.shape[-1]))
        else:
            db = a8.transpose(-1, -2) @ g8
        return da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1])


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 on the card (PyTorch's default, set
    here so that no setting of the process changes the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def product(precision: str):
    """(a, b) -> a @ b (batched where they are) in ``precision``: float64
    and float32 in that type; tf32 from TF32 operands in float32; bf16 from
    bf16 operands into a bf16 result; fp8 as ``_Fp8Product`` computes it."""
    if precision == "float64":
        return lambda a, b: a.double() @ b.double()
    if precision == "float32":
        return lambda a, b: a.float() @ b.float()
    if precision == "tf32":
        return lambda a, b: tf32(a) @ tf32(b)
    if precision == "bf16":
        return lambda a, b: a.to(torch.bfloat16) @ b.to(torch.bfloat16)
    if precision == "fp8":
        return _Fp8Product.apply
    raise ValueError(f"unknown precision {precision!r}")
