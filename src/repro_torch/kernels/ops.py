"""The port's kernel entry points, dispatched by where the operands lie.

Operands on the CPU go to the plain PyTorch version (``ref``); operands on
a CUDA device go to the hand-written kernel, which launches or raises.
There is no switch and no fallback: a CUDA tensor never reaches the plain
version through here.  Meta operands (the dry-run's) get shapes alone, and
their cost counted (``meta``).  (The JAX package's ``ops`` chooses with
``use_pallas=``; here the device decides.)

Gradients.  On the CPU autograd differentiates the plain versions.  On the
card four kinds of entry point are ``torch.autograd.Function``s whose
backward runs kernels: ``flash_attention`` (the ``flash_attention_bwd``
kernel), ``relational_matmul`` and ``moe_combine`` (``_RelationalMatmul``),
``moe_dispatch`` (``_MoeDispatch``) and ``rwkv6_scan`` (``_Rwkv6Scan``, the
``rwkv6_scan_bwd`` kernel: the recurrence walked back in time).  The MoE
ones follow the paper's Algorithm 1: the gradient of a join + group-by with
respect to its dense operand is a join + group-by over the transposed
relation (Eqs. 10/11), the ``relational_matmul`` kernel again, and with
respect to the relation's values one dot product a tuple, the ``tuple_dot``
kernel.  The two other kernels, the paper engines' ``fused_sigmoid_matmul``
and ``onehot_embed``, have no backward kernel: with grad mode on and a CUDA
operand that requires grad they raise ``NotImplementedError`` naming why,
before any launch, rather than return a result with no ``grad_fn`` (which
would leave the parameters upstream without a gradient, silently).
"""
from __future__ import annotations

import torch

from . import meta, ref
from .flash_attention import flash_attention as _flash_cuda
from .flash_attention import flash_attention_bwd as _flash_bwd_cuda
from .flash_attention import takes as _flash_takes
from .fused_sigmoid_matmul import fused_sigmoid_matmul as _fsm_cuda
from .moe_dispatch import moe_dispatch as _moe_cuda
from .onehot_embed import onehot_embed as _embed_cuda
from .relational_matmul import relational_matmul as _relmm_cuda
from .rwkv6_scan import rwkv6_scan as _rwkv6_cuda
from .rwkv6_scan import rwkv6_scan_bwd as _rwkv6_bwd_cuda
from .tuple_dot import tuple_dot as _tuple_dot_cuda


def _on_meta(*operands: torch.Tensor) -> bool:
    """True where every operand is a meta tensor (the dry-run's): the
    entry point then returns shapes alone (``meta``)."""
    return all(t.device.type == "meta" for t in operands)


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


#: kernel with no backward kernel → why (the message of the guard)
_NO_BACKWARD = {
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


def _transpose(rows, cols, vals, m: int, k: int):
    """The transpose of the relation R (``rows`` in 0..m, ``cols`` in
    0..k-1) as ``relational_matmul`` takes it: (row = col, col = row,
    value), sorted by the new row stably on the device, so the kernel's
    first pass finds it in order.  Padding tuples (row m) and tuples of
    value 0 go to the transpose's padding row k with col 0: a padding
    tuple's row lies outside the transposed product's b, and the MoE
    layer's empty slots and dropped assignments (value 0, all on one row)
    would otherwise give one warp a segment thousands of tuples long.
    Leaving them out is exact, since 0 times a finite value adds
    nothing."""
    live = (rows < m) & (vals != 0)
    t_rows = torch.where(live, cols, k)
    order = torch.argsort(t_rows, stable=True)
    return t_rows[order], torch.where(live, rows, 0)[order], vals[order]


def _transposed_product(rows, cols, vals, dout, m: int, k: int
                        ) -> torch.Tensor:
    """Rᵀ · dout, (k, n) float32: ``relational_matmul`` over
    ``_transpose``'s relation (Algorithm 1's Eqs. 10/11)."""
    if m == 0:                   # no row for a padding tuple's col
        return torch.zeros((k, dout.shape[1]), dtype=torch.float32,
                           device=dout.device)
    return _relmm_cuda(*_transpose(rows, cols, vals, m, k), dout, k)


class _RelationalMatmul(torch.autograd.Function):
    """relational_matmul on the card under autograd: the forward kernel as
    it is; the backward d b = Rᵀ · dOut (``_transposed_product``, cast to
    b's type) and d vals[t] = dOut[row_t] · b[col_t] (``tuple_dot``; a
    padding tuple's row is dOut's row count, so it gets 0).  Each runs only
    for an operand that requires grad; b is kept only for d vals."""

    @staticmethod
    def forward(ctx, row_ids, col_ids, vals, b, m: int):
        ctx.m, ctx.k, ctx.b_dtype = m, b.shape[0], b.dtype
        ctx.save_for_backward(row_ids, col_ids, vals,
                              b if ctx.needs_input_grad[2] else None)
        return _relmm_cuda(row_ids, col_ids, vals, b, m)

    @staticmethod
    def backward(ctx, dout):
        row_ids, col_ids, vals, b = ctx.saved_tensors
        dout = dout.contiguous()
        dvals = db = None
        if ctx.needs_input_grad[3]:
            db = _transposed_product(row_ids, col_ids, vals, dout, ctx.m,
                                     ctx.k).to(ctx.b_dtype)
        if ctx.needs_input_grad[2]:
            dvals = _tuple_dot_cuda(dout, row_ids, b, col_ids)
        return None, None, dvals, db, None


def relational_matmul(row_ids, col_ids, vals, b, m: int) -> torch.Tensor:
    """out (m, n) float32 = Σ over each row's tuples of vals · b[col];
    differentiable in vals and b on both routes (on the card through
    ``_RelationalMatmul``; with no operand that requires grad, or under
    ``no_grad``, the forward kernel alone, nothing recorded)."""
    if _on_meta(row_ids, col_ids, vals, b):
        return meta.relational_matmul(row_ids, col_ids, vals, b, m)
    if _on_host(row_ids, col_ids, vals, b):
        return ref.relational_matmul(row_ids, col_ids, vals, b, m)
    return _RelationalMatmul.apply(row_ids, col_ids, vals, b.contiguous(), m)


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


class _MoeDispatch(torch.autograd.Function):
    """moe_dispatch on the card under autograd: the forward kernel as it
    is; the backward, over the relation slot s → token sort_idx[s] with
    value gates[s] rounded to x's type (the factor the forward applied):
    d x = Rᵀ · dOut (``_transposed_product``, cast to x's type; the empty
    slots, gate 0, go to its padding row) and d gates[s] = dOut[s] ·
    x[sort_idx[s]] (``tuple_dot``).  Each runs only for an operand that
    requires grad; x is kept only for d gates."""

    @staticmethod
    def forward(ctx, x, sort_idx, gates):
        ctx.t, ctx.x_dtype = x.shape[0], x.dtype
        ctx.save_for_backward(sort_idx, gates,
                              x if ctx.needs_input_grad[2] else None)
        return _moe_cuda(x, sort_idx, gates)

    @staticmethod
    def backward(ctx, dout):
        sort_idx, gates, x = ctx.saved_tensors
        dout = dout.contiguous()
        slots = torch.arange(sort_idx.shape[0], dtype=torch.int32,
                             device=dout.device)
        dx = dgates = None
        if ctx.needs_input_grad[0]:
            factor = gates.to(ctx.x_dtype).to(gates.dtype)
            dx = _transposed_product(slots, sort_idx, factor, dout,
                                     slots.shape[0], ctx.t).to(ctx.x_dtype)
        if ctx.needs_input_grad[2]:
            dgates = _tuple_dot_cuda(dout, slots, x, sort_idx)
        return dx, None, dgates


def moe_dispatch(x, sort_idx, gates) -> torch.Tensor:
    """out[s, :] = gates[s] · x[sort_idx[s], :], the gate cast to x's type
    first: the MoE layer's bucket fill (the join).  Differentiable in x and
    gates on both routes (on the card through ``_MoeDispatch``; with no
    operand that requires grad, or under ``no_grad``, the forward kernel
    alone, nothing recorded)."""
    if _on_meta(x, sort_idx, gates):
        return meta.moe_dispatch(x, sort_idx, gates)
    if _on_host(x, sort_idx, gates):
        return ref.moe_dispatch(x, sort_idx, gates)
    return _MoeDispatch.apply(x.contiguous(),
                              sort_idx.to(torch.int32).contiguous(),
                              gates.to(torch.float32).contiguous())


def moe_combine(expert_out, row_ids, n_tokens: int) -> torch.Tensor:
    """Group the gated slot rows by destination token and sum, in float32,
    cast back to their type; on the card, relational_matmul's aggregation
    with unit values, reading float32 or bf16 rows as they are, through
    ``_RelationalMatmul`` (the MoE layer itself folds the gates into the
    relation and calls ``relational_matmul``)."""
    if _on_host(expert_out, row_ids):
        return ref.moe_combine(expert_out, row_ids, n_tokens)
    s = expert_out.shape[0]
    cols = torch.arange(s, dtype=torch.int32, device=expert_out.device)
    ones = torch.ones(s, dtype=torch.float32, device=expert_out.device)
    out = _RelationalMatmul.apply(row_ids.to(torch.int32).contiguous(), cols,
                                  ones, expert_out.contiguous(), n_tokens)
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
    if _on_meta(q, k, v):
        return meta.flash_attention(q, k, v, causal=causal, scale=scale,
                                    bf16_scores=bf16_scores)
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


class _Rwkv6Scan(torch.autograd.Function):
    """rwkv6_scan on the card under autograd: the forward kernel as it is,
    r, k, v, w, u and s0 saved; the backward the ``rwkv6_scan_bwd`` kernel
    (which recomputes the states, so o and s_fin are not kept).  An unused
    output's gradient arrives as None (materialize off): s_fin's in
    training, where ds_fin is then 0; ds0 is written only where s0
    requires grad.  du comes per row of state, in u's shape: where u is
    the layer's (H, N) expanded over the batch, autograd sums it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _rwkv6_cuda(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, do, ds_fin):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        grads = _rwkv6_bwd_cuda(r, k, v, w, u, s0, do, ds_fin,
                                ctx.needs_input_grad[5])
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rwkv6_scan(r, k, v, w, u, s0):
    """(o, s_fin) of the RWKV-6 recurrence; see ``rwkv6_scan.py`` for the
    shapes ((BH, S, N) or (B, H, S, N)).  Differentiable on both routes: on
    the card through ``_Rwkv6Scan`` (with no operand that requires grad, or
    under ``no_grad``, the forward kernel alone, nothing recorded)."""
    if _on_meta(r, k, v, w, u, s0):
        return meta.rwkv6_scan(r, k, v, w, u, s0)
    if _on_host(r, k, v, w, u, s0):
        return ref.rwkv6_scan(r, k, v, w, u, s0)
    r, k, v, w, u = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, w, u))
    return _Rwkv6Scan.apply(r, k, v, w, u, s0.contiguous())
