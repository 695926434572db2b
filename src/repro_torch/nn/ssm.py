"""RWKV-6 (Finch) time mix and channel mix, PyTorch port of the RWKV-6 half
of ``repro.nn.ssm`` (arXiv:2404.05892).

Time mix: a per-head N×N matrix state S with a data-dependent *vector*
decay w_t,

    o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The JAX layer runs the recurrence as a ``lax.scan`` over time; here it goes
through ``ops.rwkv6_scan``: the ``rwkv6_scan`` kernel on the card, its plain
version (the same loop over time) on the CPU.  r, k and v go to float32
before the recurrence, and the decay, the per-head group norm and the
carried states are float32, as in the JAX layer (``layers.ACCUM_DTYPE``).

Params are nested dicts as in the JAX package; the init functions take a
``torch.Generator`` (its device is where the tensors are made) and
``lead``, a stacked-layer axis prepended to every leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L
from .layers import _full, dense_init, layernorm_init

_MIX = ("r", "k", "v", "w", "g")


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------

def rwkv6_init(gen: torch.Generator, d: int, n_heads: int,
               lora_rank: int = 64, lead=()):
    n, dev = d // n_heads, gen.device
    return {
        "mu": {nm: _full((*lead, d), 0.5, dev) for nm in _MIX},
        "wr": dense_init(gen, (*lead, d, d)),
        "wk": dense_init(gen, (*lead, d, d)),
        "wv": dense_init(gen, (*lead, d, d)),
        "wg": dense_init(gen, (*lead, d, d)),
        "wo": dense_init(gen, (*lead, d, d)),
        "w0": _full((*lead, d), -2.0, dev),         # base decay ≈ exp(-e^-2)
        "w_lora_a": dense_init(gen, (*lead, d, lora_rank)),
        "w_lora_b": dense_init(gen, (*lead, lora_rank, d), scale=1e-2),
        "u": dense_init(gen, (*lead, n_heads, n), scale=0.5),
        "ln_x": layernorm_init(d, lead, dev),
    }


def _token_shift(x, x_prev):
    """x_{t-1} stream; ``x_prev`` (B, 1, d) is the carry entering this
    call."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv6_projections(p, x, x_prev, n_heads: int):
    """r, k, v, w as (B, S, H, N) and the gate g (B, S, d); w is float32."""
    b, s, d = x.shape
    xs = _token_shift(x, x_prev)
    mix = {nm: x + (xs - x) * p["mu"][nm].to(x.dtype) for nm in _MIX}
    r = mix["r"] @ p["wr"].to(x.dtype)
    k = mix["k"] @ p["wk"].to(x.dtype)
    v = mix["v"] @ p["wv"].to(x.dtype)
    g = F.silu(mix["g"] @ p["wg"].to(x.dtype))
    # Finch: data-dependent vector decay through a LoRA, in float32
    f32 = L.ACCUM_DTYPE
    lora = torch.tanh(mix["w"].to(f32) @ p["w_lora_a"].to(f32)) \
        @ p["w_lora_b"].to(f32)
    w = torch.exp(-torch.exp((p["w0"] + lora).to(f32)))
    hd = lambda t: t.reshape(b, s, n_heads, d // n_heads)
    return hd(r), hd(k), hd(v), g, hd(w)


def rwkv6_time_mix(p, x, n_heads: int, state=None):
    """x: (B, S, d). state: (x_prev (B,1,d), S (B,H,N,N)) or None.
    Returns (out (B,S,d), (x_prev, s_fin)), the new state in float32."""
    b, s, d = x.shape
    n, f32 = d // n_heads, L.ACCUM_DTYPE
    if state is None:
        x_prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((b, n_heads, n, n), dtype=f32, device=x.device)
    else:
        x_prev, s0 = state
    r, k, v, g, w = _rwkv6_projections(p, x, x_prev, n_heads)
    # (B, S, H, N) → (B, H, S, N) views: the kernel reads them by stride
    heads = lambda t: t.to(f32).transpose(1, 2)
    u = p["u"].to(f32).expand(b, n_heads, n)
    o, s_fin = ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(w), u, s0)
    o = o.transpose(1, 2)                                # (B, S, H, N)
    # per-head group norm (ln over each head's channels)
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, unbiased=False)
    o = ((o - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    o = o * p["ln_x"]["w"] + p["ln_x"]["b"]
    o = o.to(x.dtype) * g
    out = o @ p["wo"].to(x.dtype)
    return out, (x[:, -1:].to(f32), s_fin)


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------

def rwkv6_channel_mix_init(gen: torch.Generator, d: int, ff: int, lead=()):
    return {"mu_k": _full((*lead, d), 0.5, gen.device),
            "mu_r": _full((*lead, d), 0.5, gen.device),
            "wk": dense_init(gen, (*lead, d, ff)),
            "wv": dense_init(gen, (*lead, ff, d)),
            "wr": dense_init(gen, (*lead, d, d))}


def rwkv6_channel_mix(p, x, state=None):
    """x: (B, S, d); state: x_prev (B, 1, d) or None.
    Returns (out (B,S,d), x_prev of the next call in float32)."""
    b, s, d = x.shape
    x_prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
              if state is None else state)
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * p["mu_k"].to(x.dtype)
    xr = x + (xs - x) * p["mu_r"].to(x.dtype)
    h = torch.square(torch.relu(xk @ p["wk"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return r * (h @ p["wv"].to(x.dtype)), x[:, -1:].to(L.ACCUM_DTYPE)
