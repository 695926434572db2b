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

    out[i, :] = Σ_{t: row_ids[t]=i} vals[t] · b[col_ids[t], :], in float32
    (float64 where vals and b are, an oracle free of float32 rounding).
    Tuples whose row lies outside 0..m-1 (the padding, ``row_ids == m``)
    are dropped, as ``segment_sum`` drops them.
    """
    acc = torch.promote_types(torch.promote_types(vals.dtype, b.dtype),
                              torch.float32)
    joined = vals[:, None].to(acc) * b[col_ids].to(acc)
    rows = torch.where((row_ids >= 0) & (row_ids < m), row_ids, m)
    out = torch.zeros((m + 1, b.shape[1]), dtype=acc, device=b.device)
    out.index_add_(0, rows.long(), joined)       # row m collects the drops
    return out[:m]


def fused_sigmoid_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sig(X · W) — one forward CTE of the paper's model (Eq. 4)."""
    z = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (1.0 / (1.0 + torch.exp(-z))).to(x.dtype)


def onehot_embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """onehot(ids) · table — the one-hot matmul is a row gather (§4.1)."""
    return table[ids]


def moe_dispatch(x: torch.Tensor, sort_idx: torch.Tensor,
                 gates: torch.Tensor) -> torch.Tensor:
    """Dispatch side of the token→expert relation: gather each slot's token
    row and scale it by the slot's gate (the join's select clause), the
    gate cast to x's type before the product."""
    return x[sort_idx.long()] * gates[:, None].to(x.dtype)


def moe_combine(expert_out: torch.Tensor, row_ids: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """Combine side: group the relation by destination token and sum, in
    float32, cast back to the input's type (relational_matmul's
    aggregation with the values already applied)."""
    out = torch.zeros((n_tokens, expert_out.shape[1]), dtype=torch.float32,
                      device=expert_out.device)
    rows = row_ids.long()
    live = (rows >= 0) & (rows < n_tokens)         # segment_sum drops the rest
    out.index_add_(0, rows[live], expert_out[live].to(torch.float32))
    return out.to(expert_out.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    bf16_scores: bool = False) -> torch.Tensor:
    """Dense-softmax attention. q: (B, Hq, S, D); k: (B, Hkv, S, D); v:
    (B, Hkv, S, Dv) with Hq a multiple of Hkv (GQA: K/V repeated per
    query-head group); the scale defaults to D ** -0.5 (q's head dim).
    Scores and sums in float32 (float64 where q is, an oracle free of
    float32 rounding).

    ``bf16_scores`` takes the numerics of the bf16 kernel and of the JAX
    package's ``attend_flash(..., bf16_scores=True)``: q, k, v rounded to
    bf16, scores in float32, P = exp(s - max) rounded to bf16, P·V summed
    in float32, the result cast to q's type.  Its normaliser is the
    float32 sum of the rounded P, as the kernel's is; JAX also rounds each
    chunk's sum to bf16."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    out_dtype = q.dtype
    acc = torch.promote_types(q.dtype, torch.float32)
    if bf16_scores:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    if bf16_scores:
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = p.to(torch.bfloat16).to(acc)
        out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
        out = out / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(acc))
    return out.to(out_dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, scale)`` (with
    ``bf16_scores=False``) for the output gradient ``do``: the explicit
    formula, in float32 (float64 where the operands are).  P the masked
    softmax of scale q kᵀ, dV = Pᵀ dO, dP = dO vᵀ, Δ = rowsum(P ∘ dP),
    dS = P ∘ (dP − Δ), dQ = scale dS k and dK = scale dSᵀ q; a KV head's
    dK and dV sum over its query-head group.  Each gradient in its
    operand's type.  (Δ from P and dP, not from the forward's output: the
    kernel's reasons are in ``csrc/flash_attention_bwd.cu``.)"""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    kf = kf.repeat_interleave(group, dim=1)
    vf = vf.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    del logits                   # (B, Hq, S, S): keep few of them alive
    dv_full = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = torch.einsum("bhqd,bhkd->bhqk", dof, vf)              # dP
    ds.sub_((p * ds).sum(dim=-1, keepdim=True)).mul_(p)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk_full = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk_full.reshape(b, hkv, group, s, d).sum(dim=2)
    dv = dv_full.reshape(b, hkv, group, s, v.shape[-1]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, a Python loop over time on float32 state:
    o_t = r_t·(S + diag(u) k_t v_tᵀ);  S ← diag(w_t) S + k_t v_tᵀ.

    r/k/v/w: (..., S, N); u: (..., N); s0: (..., N, N), with the same
    leading axes: (BH,) as the JAX oracle takes them, or (B, H).
    Returns (o (..., S, N), s_fin (..., N, N)), both float32 (float64
    where s0 is float64).
    """
    acc = torch.promote_types(s0.dtype, torch.float32)
    r, k, v, w, u, state = (t.to(acc) for t in (r, k, v, w, u, s0))
    outs = []
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * v[..., t, None, :]
        outs.append(torch.einsum("...i,...ij->...j", r[..., t, :],
                                 state + u[..., :, None] * kv))
        state = w[..., t, :, None] * state + kv
    return torch.stack(outs, dim=-2), state
