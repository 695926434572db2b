"""Shape-only versions of the kernels' entry points, for meta operands.

The dry-run (``launch.dryrun``) runs a whole train step, prefill or decode
step on meta tensors, as DTensors placed by the sharding plan.  There a
kernel has nothing to compute, and its plain version would only spend the
host's time on shapes (``rwkv6_scan``'s loop: 32,768 steps a layer).  So
each entry point of ``ops`` sends meta operands here: the outputs come
back with the kernel's shapes and types and no storage, and the call adds
its FLOPs and bytes to the dry-run's counter (``roofline.analysis``) from
the kernel's own count, the formula of its bound in ``chip_smoke.py``
(the live score pairs of flash attention, 5 and 14 FLOPs a state cell a
step for the scan and its backward, 2 a tuple a column for the products;
bytes: each operand read once, each output written once).  Nothing here
runs on a CPU or CUDA tensor: those reach the plain versions and the
kernels, as before.

Under DTensor a call enters through ``local_map`` with the placements the
plan gives the kernel: batch over the data axes and heads over 'model',
where they divide, else replicated; the relational kernels replicate
(each device takes the whole relation).  The counts are then the local
shards', per device.  Differentiable: the backward is shape-only too, and
adds the backward kernel's count.
"""
from __future__ import annotations

import torch

from ..roofline.analysis import add_kernel_cost


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


class _ShapeOnly(torch.autograd.Function):
    """Outputs of ``make(*operands)`` with the forward's count added;
    gradients of the operands' shapes with the backward's count added."""

    @staticmethod
    def forward(ctx, make, fwd_flops, bwd_flops, *operands):
        outs = make(*operands)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        add_kernel_cost(fwd_flops, _nbytes(operands) + _nbytes(outs))
        ctx.bwd_flops = bwd_flops
        ctx.metas = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                     else None for t in operands]
        ctx.in_bytes = _nbytes(operands)
        ctx.set_materialize_grads(False)
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        out = [torch.empty(m[0], dtype=m[1], device="meta")
               if m is not None and n else None
               for m, n in zip(ctx.metas, need)]
        add_kernel_cost(ctx.bwd_flops,
                        ctx.in_bytes + _nbytes(grads) + _nbytes(out))
        return (None, None, None, *out)


def _dtensors(*operands):
    from torch.distributed.tensor import DTensor
    return [t for t in operands if isinstance(t, DTensor)]


def _plan(mesh, dims: dict, ndim: int):
    """Placements over ``mesh`` for a tensor of ``ndim`` dims: ``dims``
    maps 'data' and 'model' to the tensor dim each shards, or None."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        d = dims.get("model" if name == "model" else "data")
        out.append(Shard(d) if d is not None and d < ndim else Replicate())
    return tuple(out)


def _divides(mesh, names, *sizes) -> bool:
    n = 1
    for name in mesh.mesh_dim_names:
        if name in names:
            n *= mesh.size(mesh.mesh_dim_names.index(name))
    return all(s % n == 0 for s in sizes)


def _local(fn, operands, batch_dims, head_dims, outs_ndim, out_batch,
           out_head):
    """``fn`` on the local shards of DTensor ``operands`` (batch dim and
    heads dim of each given, None for a replicated operand), outputs
    placed with ``out_batch`` / ``out_head`` dims."""
    from torch.distributed.tensor.experimental import local_map

    mesh = _dtensors(*operands)[0].device_mesh
    data = tuple(n for n in mesh.mesh_dim_names if n != "model")
    b_ok = all(_divides(mesh, data, t.shape[d])
               for t, d in zip(operands, batch_dims) if d is not None)
    # the first operand's heads decide (the queries of GQA); an operand
    # with fewer heads than divide 'model' (GQA's keys and values) is
    # replicated over it
    h_ok = head_dims[0] is not None and _divides(
        mesh, ("model",), operands[0].shape[head_dims[0]])

    def place(ndim, b, h):
        return _plan(mesh, {"data": b if b_ok else None,
                            "model": h if h_ok else None}, ndim)

    # local_map reads a tuple as one entry an output and a list as the
    # placements of one tensor
    ins = tuple(list(place(t.dim(), b, h if h is not None and _divides(
        mesh, ("model",), t.shape[h]) else None))
                for t, b, h in zip(operands, batch_dims, head_dims))
    outs = tuple(list(place(n, b, h)) for n, b, h in zip(outs_ndim,
                                                         out_batch, out_head))
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(*operands)


def _pairs(b, hq, s, causal):
    return b * hq * (s * (s + 1) // 2 if causal else s * s)


def flash_attention(q, k, v, causal: bool = True, scale=None,
                    bf16_scores: bool = False) -> torch.Tensor:
    group = q.shape[1] // k.shape[1]

    def run(q, k, v):
        b, hq, s, d = q.shape
        dv = v.shape[-1]
        pairs = _pairs(b, hq, s, causal)
        # keys and values replicated over 'model' (fewer heads than its
        # ranks): a rank reads the key heads of its query heads alone
        k, v = (t[:, :max(1, hq // group)] if t.shape[1] * group > hq
                else t for t in (k, v))
        return _ShapeOnly.apply(
            lambda q, k, v: q.new_empty((b, hq, s, dv)),
            2 * pairs * (d + dv), 2 * pairs * (3 * d + 2 * dv), q, k, v)

    if _dtensors(q, k, v):
        return _local(run, (q, k, v), (0, 0, 0), (1, 1, 1), (4,), (0,), (1,))
    return run(q, k, v)


def rwkv6_scan(r, k, v, w, u, s0):
    def run(r, k, v, w, u, s0):
        rows = r.numel() // (r.shape[-2] * r.shape[-1])
        s, n = r.shape[-2], r.shape[-1]
        cells = rows * s * n * n
        return _ShapeOnly.apply(
            lambda r, k, v, w, u, s0: (r.new_empty(r.shape),
                                       s0.new_empty(s0.shape)),
            5 * cells, 14 * cells, r, k, v, w, u, s0)

    ops4 = r.dim() == 4
    if _dtensors(r, k, v, w, u, s0):
        b = 0 if ops4 else None
        h = 1 if ops4 else None
        return _local(run, (r, k, v, w, u, s0), (b,) * 6, (h,) * 6,
                      (r.dim(), s0.dim()), (b, b), (h, h))
    return run(r, k, v, w, u, s0)


def moe_dispatch(x, sort_idx, gates) -> torch.Tensor:
    def run(x, sort_idx, gates):
        n, d = sort_idx.shape[0], x.shape[1]
        return _ShapeOnly.apply(
            lambda x, i, g: x.new_empty((n, d)), n * d, 2 * n * d,
            x, sort_idx, gates)

    if _dtensors(x, sort_idx, gates):
        none = (None,) * 3
        return _local(run, (x, sort_idx, gates), none, none, (2,), (None,),
                      (None,))
    return run(x, sort_idx, gates)


def relational_matmul(row_ids, col_ids, vals, b, m: int) -> torch.Tensor:
    def run(row_ids, col_ids, vals, b):
        nnz, n = row_ids.shape[0], b.shape[1]
        return _ShapeOnly.apply(
            lambda r, c, x, y: y.new_empty((m, n), dtype=torch.float32),
            2 * nnz * n, 4 * nnz * n, row_ids, col_ids, vals, b)

    if _dtensors(row_ids, col_ids, vals, b):
        none = (None,) * 4
        return _local(run, (row_ids, col_ids, vals, b), none, none, (2,),
                      (None,), (None,))
    return run(row_ids, col_ids, vals, b)
