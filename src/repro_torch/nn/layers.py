"""Shared NN building blocks, PyTorch port of ``repro.nn.layers``
(dict-of-tensors params).

Conventions, as in the JAX package:
  * params are nested dicts of tensors; init functions take a
    ``torch.Generator`` (its device is where the tensors are made; the
    norms, which draw nothing, take ``device``) and return the dict.
    ``lead`` prepends a stacked-layer axis to every leaf, so ``LM.init``
    draws the whole (L, ...) stack at once.
  * compute dtype is bf16 (params stored f32, cast at use); softmax,
    normalisation statistics and losses are f32.

Full-sequence attention (``attend_flash``) is the ``flash_attention``
kernel on the card (``kernels.ops``); the decode path's ``attend`` over a
cache is plain PyTorch, as the JAX package's is plain jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

COMPUTE_DTYPE = torch.bfloat16


def cdt(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None):
    """N(0, 1) · scale in float32, scale = fan_in ** -0.5 by default
    (fan_in is ``shape[-2]``, so a stacked (L, d_in, d_out) leaf has the
    fan-in of its layers)."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return out.mul_(scale)


def _full(shape, value: float, device) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, lead=(), device="cpu"):
    return {"w": _full((*lead, d), 1.0, device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def layernorm_init(d: int, lead=(), device="cpu"):
    return {"w": _full((*lead, d), 1.0, device),
            "b": _full((*lead, d), 0.0, device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_table(seq_len: int, dim: int, theta: float = 1e4, offset: int = 0,
               device="cpu"):
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    ang = pos[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)  # (S, dim/2)


def apply_rope(x, cos, sin):
    """x: (..., S, d). Rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    c = cos.reshape(shape).to(x.dtype)
    s = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, ff: int, lead=()):
    return {"wi": dense_init(gen, (*lead, d, ff)),
            "wg": dense_init(gen, (*lead, d, ff)),
            "wo": dense_init(gen, (*lead, ff, d))}


def swiglu(p, x):
    h = (x @ cdt(p["wi"])) * F.silu(x @ cdt(p["wg"]))
    return h @ cdt(p["wo"])


def gelu_mlp_init(gen: torch.Generator, d: int, ff: int, lead=()):
    return {"wi": dense_init(gen, (*lead, d, ff)),
            "bi": _full((*lead, ff), 0.0, gen.device),
            "wo": dense_init(gen, (*lead, ff, d)),
            "bo": _full((*lead, d), 0.0, gen.device)}


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ cdt(p["wi"]) + cdt(p["bi"]), approximate="tanh")
    return h @ cdt(p["wo"]) + cdt(p["bo"])


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / qkv-bias)
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
             d_head: int, qkv_bias: bool = False, qk_norm: bool = False,
             lead=()):
    p = {"wq": dense_init(gen, (*lead, d, n_heads * d_head)),
         "wk": dense_init(gen, (*lead, d, n_kv * d_head)),
         "wv": dense_init(gen, (*lead, d, n_kv * d_head)),
         "wo": dense_init(gen, (*lead, n_heads * d_head, d))}
    if qkv_bias:
        p["bq"] = _full((*lead, n_heads * d_head), 0.0, gen.device)
        p["bk"] = _full((*lead, n_kv * d_head), 0.0, gen.device)
        p["bv"] = _full((*lead, n_kv * d_head), 0.0, gen.device)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(d_head, lead, gen.device)
        p["k_norm"] = rmsnorm_init(d_head, lead, gen.device)
    return p


def _split_heads(x, n, d_head):
    b, s, _ = x.shape
    return x.reshape(b, s, n, d_head).transpose(1, 2)  # (B, H, S, dh)


def gqa_project_qkv(p, x, n_heads: int, n_kv: int, d_head: int,
                    cos=None, sin=None):
    q = x @ cdt(p["wq"])
    k = x @ cdt(p["wk"])
    v = x @ cdt(p["wv"])
    if "bq" in p:
        q, k, v = q + cdt(p["bq"]), k + cdt(p["bk"]), v + cdt(p["bv"])
    q = _split_heads(q, n_heads, d_head)
    k = _split_heads(k, n_kv, d_head)
    v = _split_heads(v, n_kv, d_head)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attend(q, k, v, causal: bool = True, q_offset: int = 0,
           kv_len_mask=None):
    """softmax(q·kᵀ)·v with GQA head grouping. q: (B,Hq,Sq,dh), k/v (B,Hkv,Skv,dh).

    ``q_offset``: absolute position of q[...,0,:] (decode: Skv-1).
    ``kv_len_mask``: optional (B, Skv) validity mask for ragged caches.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (dh ** -0.5)
    if causal and sq > 1:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None, None], logits, -1e30)
    if kv_len_mask is not None:
        logits = torch.where(kv_len_mask[:, None, None, None, :], logits,
                             -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def attend_flash(q, k, v, causal: bool = True):
    """Full-sequence attention through ``ops.flash_attention``: the
    ``flash_attention`` kernel on the card, its plain version on the CPU.

    Same function as the JAX package's online-softmax ``attend_flash``
    (and the dense ``attend`` it falls back to for a ragged S): GQA
    softmax attention with scale d_head**-0.5 over as many keys as
    queries.  The kernel tiles by itself and takes any S, so the JAX
    version's ``chunk`` has no counterpart; its ``bf16_scores`` waits for
    the kernel's tensor-core rewrite.
    """
    return ops.flash_attention(q, k, v, causal=causal)


def merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)
