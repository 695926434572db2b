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

Full-sequence attention (``attend_flash``, and ``attend_flash_scan``, the
same function) is the ``flash_attention`` kernel on the card
(``kernels.ops``; bf16 on the tensor cores), MLA's prefill included; the
dense ``attend`` (the decode path's, over a cache) and ``attend_chunked``
are plain PyTorch, as the JAX package's are plain jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

COMPUTE_DTYPE = torch.bfloat16
#: the norms' statistics, and the ssm family's decay, recurrence, group norm
#: and carried states: float32, as in the JAX package (a test raises both
#: types to float64 to see the model's prefill and decode paths agree
#: without rounding)
ACCUM_DTYPE = torch.float32


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
    xf = x.to(ACCUM_DTYPE)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def layernorm_init(d: int, lead=(), device="cpu"):
    return {"w": _full((*lead, d), 1.0, device),
            "b": _full((*lead, d), 0.0, device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(ACCUM_DTYPE)
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

def geglu_init(gen: torch.Generator, d: int, ff: int, lead=()):
    """Zamba2-7B's shared MLP: ``gate_up`` (d, 2 ff), then ``down``."""
    return {"gate_up": dense_init(gen, (*lead, d, 2 * ff)),
            "down": dense_init(gen, (*lead, ff, d))}


def geglu(p, x, adapter=None):
    """gelu(g) · u @ down, with (g, u) the halves of x @ gate_up, exact
    GELU; ``adapter`` ({"a": (d, r), "b": (r, 2 ff)}) adds its LoRA,
    x @ a @ b, to gate_up's product (the use's own, in Zamba2)."""
    gu = x @ cdt(p["gate_up"])
    if adapter is not None:
        gu = gu + (x @ cdt(adapter["a"])) @ cdt(adapter["b"])
    g, u = gu.chunk(2, dim=-1)
    return (F.gelu(g) * u) @ cdt(p["down"])


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
           kv_len_mask=None, scale: float | None = None):
    """softmax(q·kᵀ)·v with GQA head grouping. q: (B,Hq,Sq,dh), k/v (B,Hkv,Skv,dh).

    ``q_offset``: absolute position of q[...,0,:] (decode: Skv-1).
    ``kv_len_mask``: optional (B, Skv) validity mask for ragged caches.
    ``scale``: the softmax scale, dh ** -0.5 by default.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (
                              dh ** -0.5 if scale is None else scale)
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


def auto_chunk(seq_len: int) -> int:
    """The JAX package's flash chunk size: ≥1024, ≤4096, ~seq/8."""
    return max(1024, min(4096, seq_len // 8))


def attend_flash(q, k, v, causal: bool = True, bf16_scores: bool = False,
                 chunk: int | None = None, scale: float | None = None):
    """Full-sequence attention through ``ops.flash_attention``: the
    ``flash_attention`` kernels on the card, their plain version on the CPU.

    Same function as the JAX package's online-softmax ``attend_flash``
    (and the dense ``attend`` it falls back to for a ragged S): GQA
    softmax attention with scale d_head**-0.5 (q's head dim; v's may be
    narrower, as MLA's is) over as many keys as queries.  The kernels tile
    by themselves and take any S, so the JAX version's ``chunk`` (default
    ``auto_chunk(S)``) only decides, as it does there, where
    ``bf16_scores`` holds: with S a multiple of min(chunk, S); otherwise
    JAX falls back to its float32 dense function and so does this.
    ``bf16_scores`` rounds q, k, v and P to bf16 around float32 scores and
    sums, which on the card is the bf16 tensor-core kernel.  ``scale``
    replaces d_head**-0.5 (Zamba2-7B's (d_head / 2) ** -0.5).
    """
    s = q.shape[2]
    chunk = min(chunk or auto_chunk(s), s)
    return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                               bf16_scores=bf16_scores and s % chunk == 0)


def attend_flash_scan(q, k, v, causal: bool = True,
                      scale: float | None = None):
    """The JAX package's ``attend_flash_scan``: ``attend_flash`` with its kv
    loop as a ``lax.scan`` (the dry-run's memory model), float32 scores
    always, the dense ``attend`` for a ragged S.  All three compute one
    function, so here it is ``ops.flash_attention`` as ``attend_flash``
    runs it without ``bf16_scores``: the kernel on the card, its plain
    version on the CPU."""
    return ops.flash_attention(q, k, v, causal=causal, scale=scale)


def attend_chunked(q, k, v, chunk: int = 2048, q_offset: int = 0,
                   scale: float | None = None):
    """Causal attention per q-chunk against only the kv prefix that chunk
    can see (the JAX package's ``attend_chunked``): dense ``attend`` on
    each chunk, so no strictly-future block is computed.  Plain PyTorch,
    as the JAX version is jnp outside any kernel."""
    sq = q.shape[2]
    if sq <= chunk:
        return attend(q, k, v, causal=True, q_offset=q_offset, scale=scale)
    assert sq % chunk == 0
    outs = []
    for lo in range(0, sq, chunk):
        kv_hi = q_offset + lo + chunk
        outs.append(attend(q[:, :, lo:lo + chunk], k[:, :, :kv_hi],
                           v[:, :, :kv_hi], causal=True,
                           q_offset=q_offset + lo, scale=scale))
    return torch.cat(outs, dim=2)


def merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (kv_lora compression)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, d: int, n_heads: int, kv_lora: int,
             d_nope: int, d_rope: int, d_v: int, lead=()):
    return {
        "wq": dense_init(gen, (*lead, d, n_heads * (d_nope + d_rope))),
        "wkv_a": dense_init(gen, (*lead, d, kv_lora)),         # compress
        "kv_a_norm": rmsnorm_init(kv_lora, lead, gen.device),
        "wk_b": dense_init(gen, (*lead, kv_lora, n_heads * d_nope)),
        "wv_b": dense_init(gen, (*lead, kv_lora, n_heads * d_v)),
        "wk_rope": dense_init(gen, (*lead, d, d_rope)),        # shared rope key
        "wo": dense_init(gen, (*lead, n_heads * d_v, d)),
    }


def mla_qkv(p, x, n_heads: int, d_nope: int, d_rope: int, d_v: int,
            cos, sin):
    """Returns q (B,H,S,d_nope+d_rope), k (same), v (B,H,S,d_v) and the
    latent c_kv (B,S,kv_lora).

    The latent and the shared k_rope (B,S,d_rope) are what the serving
    cache stores; here they expand to full heads for the attention product
    (the decode step attends in the latent space instead)."""
    b, s, _ = x.shape
    q = (x @ cdt(p["wq"])).reshape(b, s, n_heads, d_nope + d_rope)
    q = q.transpose(1, 2)
    q = torch.cat([q[..., :d_nope], apply_rope(q[..., d_nope:], cos, sin)],
                  dim=-1)
    c_kv = rmsnorm(p["kv_a_norm"], x @ cdt(p["wkv_a"]))
    k_nope = (c_kv @ cdt(p["wk_b"])).reshape(b, s, n_heads, d_nope)
    k_rope = apply_rope((x @ cdt(p["wk_rope"]))[:, None], cos, sin)
    k = torch.cat([k_nope.transpose(1, 2),
                   k_rope.expand(b, n_heads, s, d_rope)], dim=-1)
    v = (c_kv @ cdt(p["wv_b"])).reshape(b, s, n_heads, d_v).transpose(1, 2)
    return q, k, v, c_kv
