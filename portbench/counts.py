"""Operation and byte counts, frozen here: the work each call into the
program needs, computed from the operands handed to it (never from a
kernel's name, so that it reads the same work whatever implements it),
and the model FLOPs of a pass or a token.

A call's least time is the larger of its products' time, each priced at
the fastest tensor-core rate for its precision (``peaks``), and its bytes
over the HBM bandwidth, with each input byte read once and each output
byte written once.  A work function returns (forward, backward) least
seconds; the backward's is charged only when the call's autograd nodes
run."""
from __future__ import annotations

import dataclasses

import torch

from . import peaks


@dataclasses.dataclass
class Work:
    flops_f32: float = 0.0     # products with a float32 operand
    flops_bf16: float = 0.0    # products of bf16 operands only
    bytes: float = 0.0

    def seconds(self) -> float:
        return max(self.flops_f32 / peaks.F32_FLOPS
                   + self.flops_bf16 / peaks.BF16_FLOPS,
                   self.bytes / peaks.HBM_BYTES_PER_S)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flops(work: Work, flops: float, *operands: torch.Tensor) -> None:
    if all(t.dtype in (torch.bfloat16, torch.float16) for t in operands):
        work.flops_bf16 += flops
    else:
        work.flops_f32 += flops


# -- the relational engine ---------------------------------------------------

def relmm_relation(args, kwargs, out):
    """``RelTensor.matmul(self, other)``: each of the left relation's
    tuples (i, j, v) joins row j of the canonical right relation (only its
    values are needed) and the group-by sums into the (m, n) result, which
    the call returns as a relation (i, j, v)."""
    left, right = args[0], args[1]
    n = right.shape[1]
    w = Work(bytes=nbytes(left.i) + nbytes(left.j) + nbytes(left.v)
             + nbytes(right.v) + nbytes(out.i) + nbytes(out.j)
             + nbytes(out.v))
    _flops(w, 2.0 * left.capacity * n, left.v, right.v)
    return w.seconds(), 0.0


# -- the dense engine ---------------------------------------------------------

def sigmoid_matmul(args, kwargs, out):
    """``ops.fused_sigmoid_matmul(x, w)``: sig(x @ w)."""
    x, w_ = args[0], args[1]
    (m, k), n = x.shape, w_.shape[1]
    w = Work(bytes=nbytes(x) + nbytes(w_) + nbytes(out))
    _flops(w, 2.0 * m * k * n, x, w_)
    return w.seconds(), 0.0


# -- the relational MoE -------------------------------------------------------

def moe_dispatch(args, kwargs, out):
    """``ops.moe_dispatch(x, sort_idx, gates)``: out[s] = gates[s] *
    x[sort_idx[s]].  Backward: d x = the transposed relation times d out
    (x requires grad), d gates one dot product a slot (gates require
    grad)."""
    x, idx, gates = args[0], args[1], args[2]
    s, d = out.shape
    fwd = Work(bytes=nbytes(x) + nbytes(idx) + nbytes(gates) + nbytes(out))
    _flops(fwd, float(s * d), x, gates)
    bwd = Work(bytes=nbytes(out) + nbytes(idx) + nbytes(gates))
    if x.requires_grad:
        bwd.bytes += nbytes(x)
        _flops(bwd, 2.0 * s * d, out, gates)
    if gates.requires_grad:
        bwd.bytes += nbytes(x) * (not x.requires_grad) + nbytes(gates)
        _flops(bwd, 2.0 * s * d, out, x)
    return fwd.seconds(), bwd.seconds()


def relational_matmul(args, kwargs, out):
    """``ops.relational_matmul(rows, cols, vals, b, m)``: out (m, n)
    float32 = per row, the sum of vals * b[col] over its tuples.
    Backward: d b = the transposed relation times d out, d vals one dot
    product a tuple."""
    rows, cols, vals, b = args[:4]
    nnz, n = rows.shape[0], b.shape[1]
    rel = nbytes(rows) + nbytes(cols) + nbytes(vals)
    fwd = Work(bytes=rel + nbytes(b) + nbytes(out))
    _flops(fwd, 2.0 * nnz * n, vals, b)
    bwd = Work(bytes=rel + nbytes(out))
    if b.requires_grad:
        bwd.bytes += nbytes(b)
        _flops(bwd, 2.0 * nnz * n, vals, out)
    if vals.requires_grad:
        bwd.bytes += nbytes(b) * (not b.requires_grad) + nbytes(vals)
        _flops(bwd, 2.0 * nnz * n, out, b)
    return fwd.seconds(), bwd.seconds()


# -- attention -----------------------------------------------------------------

def _pairs(sq: int, sk: int, causal: bool) -> float:
    """Query-key pairs a head scores: the causal triangle of a square
    problem, every pair otherwise."""
    return sq * (sq + 1) / 2.0 if causal and sq == sk else float(sq * sk)


def flash_attention(args, kwargs, out):
    """``ops.flash_attention(q, k, v, causal=True, ...)``: softmax(q kᵀ
    scale) v per head.  Forward: S = q kᵀ and P v, 2 D + 2 Dv a pair.
    Backward (from q, k, v and d out, no P kept): S again, d P = d out vᵀ,
    d v = Pᵀ d out, d q = d S k, d k = d Sᵀ q, 6 D + 4 Dv a pair."""
    q, k, v = args[0], args[1], args[2]
    causal = args[3] if len(args) > 3 else kwargs.get("causal", True)
    bf16 = kwargs.get("bf16_scores", False)
    b, hq, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[3]
    pairs = b * hq * _pairs(sq, sk, causal)
    ops = (q, k, v) if not bf16 else (q.to(torch.bfloat16),)
    fwd = Work(bytes=nbytes(q) + nbytes(k) + nbytes(v) + nbytes(out))
    _flops(fwd, pairs * (2 * d + 2 * dv), *ops)
    bwd = Work(bytes=2 * (nbytes(q) + nbytes(k) + nbytes(v)) + nbytes(out))
    _flops(bwd, pairs * (6 * d + 4 * dv), *ops)
    return fwd.seconds(), bwd.seconds()


# -- model FLOPs ---------------------------------------------------------------

def mlp_pass_flops(c: dict, rows: int) -> float:
    """A training iteration of the two-layer MLP over ``rows`` rows: 2 FLOPs
    a weight and row forward, 4 more in the backward (Eqs. 6-11)."""
    weights = (c["n_features"] * c["n_hidden"]
               + c["n_hidden"] * c["n_classes"])
    return 6.0 * rows * weights


def lm_active_params(c: dict) -> int:
    """The parameters a token's products touch, in an MLA + MoE model: MLA
    in every layer, the dense layers' SwiGLU, each MoE layer's router,
    ``num_experts_per_tok`` routed and the shared experts, and the output
    head (the embedding is a lookup, the norms elementwise)."""
    d = c["hidden_size"]
    h, kv = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    f = c["moe_intermediate_size"]
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    mla = (d * h * (dn + dr) + d * kv + kv * h * dn + kv * h * dv + d * dr
           + h * dv * d)
    dense_ffn = 3 * d * c["intermediate_size"]
    moe_ffn = (3 * d * f * (c["num_experts_per_tok"] + c["n_shared_experts"])
               + d * c["n_routed_experts"])
    return (c["num_hidden_layers"] * mla + n_dense * dense_ffn
            + n_moe * moe_ffn + d * c["vocab_size"])


def lm_train_flops_per_token(c: dict, seq_len: int) -> float:
    """6 x the active parameters, plus causal attention forward and
    backward (3 x its forward: 2 (D + Dv) a query-key pair, (S + 1) / 2
    keys a query on average).  Recompute is not counted."""
    h = c["num_attention_heads"]
    d_qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    attn_fwd = h * 2 * (d_qk + c["v_head_dim"]) * (seq_len + 1) / 2.0
    return (6.0 * lm_active_params(c)
            + 3.0 * attn_fwd * c["num_hidden_layers"])
