"""Gradient compression for a thin link, PyTorch port of
``repro.optim.compression``.

int8 block quantisation with error feedback: the quantisation residual is
carried to the next step, so compression error accumulates to zero in
expectation (1-bit Adam / EF-SGD lineage).  The JAX package uses it for
the ``pod`` axis all-reduce; here ``compressed_psum`` is a
``torch.distributed`` all-reduce (mean) of the dequantised blocks over a
process group.  ``quantize_int8`` and ``dequantize_int8`` give JAX's bits:
the scale is max|x| / 127 + 1e-12 in float32 and both round half to even.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import leaves, tree_map, unflatten

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), pad


def quantize_int8(x: torch.Tensor):
    """→ (q int8 [n/B, B], scales float32 [n/B, 1], meta) block-wise
    symmetric."""
    flat, pad = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(x.shape), pad)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, meta):
    shape, pad = meta
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Quantise (grad + carried error); return (q, scale, meta, new_error)."""
    target = grad.to(torch.float32) + error
    q, scale, meta = quantize_int8(target)
    recon = dequantize_int8(q, scale, meta)
    return q, scale, meta, target - recon


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, errors, group=None):
    """Error-feedback int8 all-reduce (mean) over the process ``group``
    (the default group when None).  Returns (reduced_grads, new_errors).
    The dequantised blocks are reduced, not the int8 values (an int8 sum
    would overflow; the wire format is int8 + a per-block scale)."""
    world = dist.get_world_size(group)

    def one(g, e):
        q, scale, meta, new_e = compress_with_feedback(g, e)
        deq = dequantize_int8(q, scale, meta)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return deq / world, new_e

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, (r for r, _ in out)),
            unflatten(grads, (e for _, e in out)))
