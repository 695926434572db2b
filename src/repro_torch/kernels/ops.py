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
from .fused_sigmoid_matmul import fused_sigmoid_matmul as _fsm_cuda
from .onehot_embed import onehot_embed as _embed_cuda
from .relational_matmul import relational_matmul as _relmm_cuda


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


def flash_attention(q, k, v, causal: bool = True, scale=None) -> torch.Tensor:
    if _on_host(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return _flash_cuda(q, k, v, causal=causal, scale=scale)
