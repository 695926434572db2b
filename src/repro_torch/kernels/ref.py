"""Plain PyTorch versions of the kernels on the port's path (the ``ref.py``
contract of ``repro.kernels.ref``).

Each function is the semantic ground truth, with the reference's float32
casts and output types: the CPU path runs them, and ``chip_smoke.py``
holds every CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def relational_matmul(row_ids: torch.Tensor, col_ids: torch.Tensor,
                      vals: torch.Tensor, b: torch.Tensor, m: int
                      ) -> torch.Tensor:
    """The paper's join + group-by matmul over a COO relation.

    out[i, :] = Σ_{t: row_ids[t]=i} vals[t] · b[col_ids[t], :], in float32.
    Tuples whose row lies outside 0..m-1 (the padding, ``row_ids == m``)
    are dropped, as ``segment_sum`` drops them.
    """
    joined = vals[:, None].to(torch.float32) * b[col_ids].to(torch.float32)
    rows = torch.where((row_ids >= 0) & (row_ids < m), row_ids, m)
    out = torch.zeros((m + 1, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    out.index_add_(0, rows.long(), joined)       # row m collects the drops
    return out[:m]


def fused_sigmoid_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sig(X · W) — one forward CTE of the paper's model (Eq. 4)."""
    z = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (1.0 / (1.0 + torch.exp(-z))).to(x.dtype)


def onehot_embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """onehot(ids) · table — the one-hot matmul is a row gather (§4.1)."""
    return table[ids]
