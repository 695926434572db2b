"""The port's kernel entry points, dispatched by where the operands lie.

Operands on the CPU go to the plain PyTorch version (``ref``); operands on
a CUDA device go to the hand-written kernel, which launches or raises.
There is no switch and no fallback: a CUDA tensor never reaches the plain
version through here.  (The JAX package's ``ops`` chooses with
``use_pallas=``; here the device decides.)
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as _flash_cuda
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


def relational_matmul(row_ids, col_ids, vals, b, m: int) -> torch.Tensor:
    if _on_host(row_ids, col_ids, vals, b):
        return ref.relational_matmul(row_ids, col_ids, vals, b, m)
    return _relmm_cuda(row_ids, col_ids, vals, b.contiguous(), m)


def fused_sigmoid_matmul(x, w) -> torch.Tensor:
    if _on_host(x, w):
        return ref.fused_sigmoid_matmul(x, w)
    return _fsm_cuda(x.contiguous(), w.contiguous())


def onehot_embed(ids, table) -> torch.Tensor:
    if _on_host(ids, table):
        return ref.onehot_embed(ids, table)
    return _embed_cuda(ids.to(torch.int32).contiguous(), table.contiguous())


def moe_dispatch(x, sort_idx, gates) -> torch.Tensor:
    """out[s, :] = gates[s] · x[sort_idx[s], :], the gate cast to x's type
    first: the MoE layer's bucket fill (the join)."""
    if _on_host(x, sort_idx, gates):
        return ref.moe_dispatch(x, sort_idx, gates)
    return _moe_cuda(x.contiguous(), sort_idx.to(torch.int32).contiguous(),
                     gates.to(torch.float32).contiguous())


def moe_combine(expert_out, row_ids, n_tokens: int) -> torch.Tensor:
    """Group the gated slot rows by destination token and sum, in float32,
    cast back to their type; on the card, relational_matmul's aggregation
    with unit values (the MoE layer itself folds the gates into the
    relation and calls ``relational_matmul``)."""
    if _on_host(expert_out, row_ids):
        return ref.moe_combine(expert_out, row_ids, n_tokens)
    s = expert_out.shape[0]
    cols = torch.arange(s, dtype=torch.int32, device=expert_out.device)
    ones = torch.ones(s, dtype=torch.float32, device=expert_out.device)
    out = _relmm_cuda(row_ids.to(torch.int32).contiguous(), cols, ones,
                      expert_out.to(torch.float32).contiguous(), n_tokens)
    return out.to(expert_out.dtype)


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    bf16_scores: bool = False) -> torch.Tensor:
    """GQA softmax attention; ``bf16_scores`` rounds q, k, v and P to bf16
    (float32 scores and sums), cast back to q's type: on the card the bf16
    kernel, whose numerics these are.  An operand the kernel cannot read in
    place (a last stride other than 1; in bf16 a base or stride off TMA's
    16 bytes) is copied first."""
    if _on_host(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   bf16_scores=bf16_scores)
    out_dtype = q.dtype
    if bf16_scores:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    q, k, v = (t if _flash_takes(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    return _flash_cuda(q, k, v, causal=causal, scale=scale).to(out_dtype)


def rwkv6_scan(r, k, v, w, u, s0):
    """(o, s_fin) of the RWKV-6 recurrence; see ``rwkv6_scan.py`` for the
    shapes ((BH, S, N) or (B, H, S, N))."""
    if _on_host(r, k, v, w, u, s0):
        return ref.rwkv6_scan(r, k, v, w, u, s0)
    r, k, v, w, u = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, w, u))
    return _rwkv6_cuda(r, k, v, w, u, s0.contiguous())
