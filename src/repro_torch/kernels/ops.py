"""The port's kernel entry points, dispatched by where the operands lie.

Operands on the CPU go to the plain PyTorch version (``ref``); operands on
a CUDA device go to the hand-written kernel, which launches or raises.
There is no switch and no fallback: a CUDA tensor never reaches the plain
version through here.  (The JAX package's ``ops`` chooses with
``use_pallas=``; here the device decides.)

Gradients.  On the CPU autograd differentiates the plain versions.  On the
card ``flash_attention`` is a ``torch.autograd.Function`` whose backward is
the ``flash_attention_bwd`` kernel.  The other kernels have no backward
kernel yet: with grad mode on and a CUDA operand that requires grad they
raise ``NotImplementedError`` naming the ``ROADMAP.md`` slice that brings
one, before any launch, rather than return a result with no ``grad_fn``
(which would leave the parameters upstream without a gradient, silently).
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as _flash_cuda
from .flash_attention import flash_attention_bwd as _flash_bwd_cuda
from .flash_attention import takes as _flash_takes
from .fused_sigmoid_matmul import fused_sigmoid_matmul as _fsm_cuda
from .moe_dispatch import moe_dispatch as _moe_cuda
from .onehot_embed import onehot_embed as _embed_cuda
from .relational_matmul import relational_matmul as _relmm_cuda
from .rwkv6_scan import rwkv6_scan as _rwkv6_cuda


def _on_host(*operands: torch.Tensor) -> bool:
    """True for CPU operands, False for CUDA ones; raises on anything else
    or a mix."""
    kinds = {t.device.type for t in operands}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel operands on {sorted(kinds)}: need all on the "
                     "CPU or all on CUDA")


_MOE_SLICE = "ROADMAP.md, the slice after LM training: MoE training"
#: kernel → where its backward comes from (the message of the guard)
_NO_BACKWARD = {
    "relational_matmul": f"on the MoE combine, {_MOE_SLICE}; the paper's "
                         "engines differentiate in their own IR (Algorithm "
                         "1) and pass no operand that requires grad",
    "moe_dispatch": _MOE_SLICE,
    "moe_combine": _MOE_SLICE,
    "rwkv6_scan": "ROADMAP.md, the second slice after LM training: RWKV-6 "
                  "training (a reverse-time scan kernel)",
    "fused_sigmoid_matmul": "no slice brings one: the paper's dense engine "
                            "differentiates in its own IR (Algorithm 1)",
    "onehot_embed": "no slice brings one: the one-hot label transform takes "
                    "no gradient",
}


def _no_grad_through(kernel: str, *operands: torch.Tensor) -> None:
    """Raise where autograd would need the backward of a kernel that has
    none (a CUDA operand requiring grad, with grad mode on)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise NotImplementedError(
            f"{kernel} on the card has no backward kernel: "
            f"{_NO_BACKWARD[kernel]}. "
            "Run under torch.no_grad(), detach the operands, or train on "
            "the CPU through the plain versions")


def relational_matmul(row_ids, col_ids, vals, b, m: int) -> torch.Tensor:
    if _on_host(row_ids, col_ids, vals, b):
        return ref.relational_matmul(row_ids, col_ids, vals, b, m)
    _no_grad_through("relational_matmul", vals, b)
    return _relmm_cuda(row_ids, col_ids, vals, b.contiguous(), m)


def fused_sigmoid_matmul(x, w) -> torch.Tensor:
    if _on_host(x, w):
        return ref.fused_sigmoid_matmul(x, w)
    _no_grad_through("fused_sigmoid_matmul", x, w)
    return _fsm_cuda(x.contiguous(), w.contiguous())


def onehot_embed(ids, table) -> torch.Tensor:
    if _on_host(ids, table):
        return ref.onehot_embed(ids, table)
    _no_grad_through("onehot_embed", table)
    return _embed_cuda(ids.to(torch.int32).contiguous(), table.contiguous())


def moe_dispatch(x, sort_idx, gates) -> torch.Tensor:
    """out[s, :] = gates[s] · x[sort_idx[s], :], the gate cast to x's type
    first: the MoE layer's bucket fill (the join)."""
    if _on_host(x, sort_idx, gates):
        return ref.moe_dispatch(x, sort_idx, gates)
    _no_grad_through("moe_dispatch", x, gates)
    return _moe_cuda(x.contiguous(), sort_idx.to(torch.int32).contiguous(),
                     gates.to(torch.float32).contiguous())


def moe_combine(expert_out, row_ids, n_tokens: int) -> torch.Tensor:
    """Group the gated slot rows by destination token and sum, in float32,
    cast back to their type; on the card, relational_matmul's aggregation
    with unit values, reading float32 or bf16 rows as they are (the MoE
    layer itself folds the gates into the relation and calls
    ``relational_matmul``)."""
    if _on_host(expert_out, row_ids):
        return ref.moe_combine(expert_out, row_ids, n_tokens)
    _no_grad_through("moe_combine", expert_out)
    s = expert_out.shape[0]
    cols = torch.arange(s, dtype=torch.int32, device=expert_out.device)
    ones = torch.ones(s, dtype=torch.float32, device=expert_out.device)
    out = _relmm_cuda(row_ids.to(torch.int32).contiguous(), cols, ones,
                      expert_out.contiguous(), n_tokens)
    return out.to(expert_out.dtype)


class _FlashAttention(torch.autograd.Function):
    """The card's flash attention under autograd: forward the existing
    kernels (as they are), backward the ``flash_attention_bwd`` kernel on
    the saved operands (it recomputes P, so the output is not kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash_cuda(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        do = do.to(q.dtype)
        if not _flash_takes(do):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _flash_bwd_cuda(q, k, v, do, causal=ctx.causal,
                                     scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    bf16_scores: bool = False) -> torch.Tensor:
    """GQA softmax attention; ``bf16_scores`` rounds q, k, v and P to bf16
    (float32 scores and sums), cast back to q's type: on the card the bf16
    kernel, whose numerics these are.  An operand the kernel cannot read in
    place (a last stride other than 1; in bf16 a base or stride off TMA's
    16 bytes) is copied first.  Differentiable on both routes: on the card
    through ``_FlashAttention`` (the gradient is that of the float32-P
    function, ``bf16_scores=False``, whatever the forward rounded, at the
    operands the kernel was given and dO in their type: rounded to bf16
    under ``bf16_scores``; with no operand that requires grad, or under
    ``no_grad``, it runs the forward kernel alone and records nothing)."""
    if _on_host(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   bf16_scores=bf16_scores)
    out_dtype = q.dtype
    if bf16_scores:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    q, k, v = (t if _flash_takes(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, scale).to(out_dtype)


def rwkv6_scan(r, k, v, w, u, s0):
    """(o, s_fin) of the RWKV-6 recurrence; see ``rwkv6_scan.py`` for the
    shapes ((BH, S, N) or (B, H, S, N))."""
    if _on_host(r, k, v, w, u, s0):
        return ref.rwkv6_scan(r, k, v, w, u, s0)
    _no_grad_through("rwkv6_scan", r, k, v, w, u, s0)
    r, k, v, w, u = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, w, u))
    return _rwkv6_cuda(r, k, v, w, u, s0.contiguous())
