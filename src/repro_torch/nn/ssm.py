"""Recurrent sequence mixers, PyTorch port of ``repro.nn.ssm``: RWKV-6
(Finch) and Mamba-2 (SSD).

RWKV-6 time mix (arXiv:2404.05892): a per-head N×N matrix state S with a
data-dependent *vector* decay w_t,

    o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The JAX layer runs the recurrence as a ``lax.scan`` over time (and trains
through ``jax.grad`` of it); here it goes through ``ops.rwkv6_scan``: the
``rwkv6_scan`` kernel on the card, with the ``rwkv6_scan_bwd`` kernel as its
gradient, and its plain version (the same loop over time, differentiated by
autograd) on the CPU.  r, k and v go to float32
before the recurrence, and the decay, the per-head group norm and the
carried states are float32, as in the JAX layer (``layers.ACCUM_DTYPE``).

Mamba-2 SSD (arXiv:2405.21060): a *scalar* decay per head, so the chunked
block decomposition is stable.  Diagonal blocks take the masked-decay
product, off-diagonal ones flow through a chunk-state recurrence.  It has
no Pallas kernel in the JAX package and none here: on the card it is
PyTorch products, cumulative sums and exponentials.  Each of the JAX
version's four-operand einsums is written as two-operand steps in the
order that keeps the intermediates small: ``Cs·Bs``, then ``L``, then
``xs`` for the diagonal blocks, where contracting ``Bs`` with ``xs`` first
would build a (B, nc, C, N, H, P) tensor (10.7 GB at Zamba2-2.7B's
prefill).  With ``compute_dtype`` bf16 the chunk tensors (x, B, C, L, the
decays, the entering states) are rounded to bf16 where JAX rounds them and
every product accumulates in float32; the decay cumsums and the state h
stay float32.  That float32 is ``layers.ACCUM_DTYPE``, as RWKV-6's is, so
an oracle can raise the whole mixer to float64.

Zamba2-7B's mixer as published adds B and C in ``n_groups`` groups (head
h reads group h // (H / G); ``ssd_chunked`` takes them as (B, S, G, N)), a
bias on the depthwise conv, D applied to x before the dt scaling (the JAX
version applies it to x·dt) and the gated RMSNorm of ``transformers``'
``Zamba2RMSNormGated``: y·silu(z) in float32, normalised in
``norm_groups`` groups.  The defaults are the JAX version's.

Params are nested dicts as in the JAX package; the init functions take a
``torch.Generator`` (its device is where the tensors are made) and
``lead``, a stacked-layer axis prepended to every leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import obs
from ..kernels import ops
from . import layers as L
from .layers import _full, dense_init, layernorm_init, rmsnorm_init

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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): chunked block decomposition
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, d: int, n_heads: int, d_state: int,
                d_conv: int = 4, expand: int = 2, lead=(), n_groups: int = 1,
                conv_bias: bool = False):
    d_inner, dev = expand * d, gen.device
    conv = d_inner + 2 * n_groups * d_state
    p = {
        # in_proj emits z (gate), x, B, C (n_groups each), dt
        "in_proj": dense_init(gen, (*lead, d, d_inner + conv + n_heads)),
        "conv_w": dense_init(gen, (*lead, d_conv, conv), scale=0.5),
        "a_log": _full((*lead, n_heads), 0.0, dev),
        "dt_bias": _full((*lead, n_heads), 0.0, dev),
        "d_skip": _full((*lead, n_heads), 1.0, dev),
        "norm": rmsnorm_init(d_inner, lead, dev),
        "out_proj": dense_init(gen, (*lead, d_inner, d)),
    }
    if conv_bias:
        p["conv_b"] = _full((*lead, conv), 0.0, dev)
    return p


def _segsum(a):
    """exp-able segment sums: out[..., t, s] = Σ_{r=s+1..t} a[..., r] for
    t ≥ s, -inf above the diagonal; a difference of cumulative sums, as
    the JAX version takes it."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _accum() -> torch.dtype:
    """``layers.ACCUM_DTYPE`` (float32), read at the call: inside the SSD
    ``L`` names its decay matrix."""
    return L.ACCUM_DTYPE


def _f32(*ts):
    """float32 views of the operands of a product that accumulates in
    float32 (bf16 widens exactly): ``layers.ACCUM_DTYPE``."""
    return tuple(t.to(_accum()) for t in ts)


def _step(x, a, b_in, c_in, h_prev):
    """One token of the recurrence: h ← exp(a) h + b xᵀ, y = c · h, in
    float32.  x (B,H,P), a (B,H), b_in/c_in (B,N) or a head's own (B,H,N),
    h_prev (B,H,N,P)."""
    f32 = L.ACCUM_DTYPE
    da = torch.exp(a)
    hd = "h" if b_in.dim() == 3 else ""
    h = h_prev * da[..., None, None] + torch.einsum(
        f"b{hd}n,bhp->bhnp", b_in.to(f32), x.to(f32))
    return torch.einsum(f"b{hd}n,bhnp->bhp", c_in.to(f32), h), h


def _per_head(t, h: int):
    """(B, S, G, N) groups → (B, S, H, N), head h reading group h // (H /
    G); (B, S, N) as it is."""
    if t.dim() == 3:
        return t
    return t.repeat_interleave(h // t.shape[2], dim=2)


def _recurrence(chunk_decay, states, h0, shape, dtype, device):
    """The inter-chunk recurrence on the float32 state: (the state entering
    each chunk (B,nc,H,N,P), the final state).  Each chunk's decay and state
    are unbound once, not indexed chunk by chunk: under autograd,
    states[:, z] would fill and add a zero gradient of the whole (B, nc,
    H, N, P) tensor for every chunk."""
    hcur = (torch.zeros(shape, dtype=dtype, device=device)
            if h0 is None else h0)
    h_prevs = []
    for dz, sz in zip(chunk_decay.unbind(2), states.unbind(1)):
        h_prevs.append(hcur)
        hcur = hcur * dz[..., None, None] + sz
    return torch.stack(h_prevs, dim=1), hcur


def ssd_chunked(x, a, b_in, c_in, chunk: int = 64, h0=None,
                compute_dtype=torch.float32):
    """Mamba-2 SSD. x: (B,S,H,P), a: (B,S,H) log-decay (≤0), b_in/c_in:
    (B,S,N), or (B,S,G,N) in G groups (head h reads group h // (H / G); G
    = 1 runs the (B,S,N) arithmetic bit for bit). Returns (y (B,S,H,P) in
    x's type, h_fin (B,H,N,P) float32).  ``compute_dtype=bf16`` keeps the
    big chunk tensors in bf16 (the decay cumsums stay float32)."""
    if b_in.dim() == 4 and b_in.shape[2] == 1:
        b_in, c_in = b_in[:, :, 0], c_in[:, :, 0]
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    f32 = _accum()
    assert s % chunk == 0 or s == 1
    if s == 1:                      # decode step: the plain recurrence
        h_prev = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
                  if h0 is None else h0)
        y, hb = _step(x[:, 0], a[:, 0], _per_head(b_in, h)[:, 0],
                      _per_head(c_in, h)[:, 0], h_prev)
        return y[:, None].to(x.dtype), hb
    if b_in.dim() == 4:
        return _ssd_groups(x, a, b_in, c_in, chunk, h0, compute_dtype)
    nc = s // chunk
    cd = compute_dtype
    xs = x.reshape(bsz, nc, chunk, h, p).to(cd)
    As = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2).to(f32)  # (B,H,nc,C)
    Bs = b_in.reshape(bsz, nc, chunk, n).to(cd)
    Cs = c_in.reshape(bsz, nc, chunk, n).to(cd)
    A_cum = torch.cumsum(As, dim=-1)                              # (B,H,nc,C)
    # 1. diagonal blocks: (Cs·Bs) ∘ L, then · xs
    L = torch.exp(_segsum(As)).to(cd)                             # (B,H,nc,C,C)
    cb = torch.einsum("bzln,bzsn->bzls", *_f32(Cs, Bs))
    m = cb[:, None] * L.to(f32)                                   # (B,H,nc,l,s)
    xs32 = xs.to(f32)
    y_diag = torch.einsum("bhzls,bzshp->bzlhp", m, xs32)
    del cb, m
    # 2. chunk states (decay to the chunk's end): (decay ∘ xs), then · Bs
    decay_states = torch.exp(A_cum[..., -1:] - A_cum).to(cd)     # (B,H,nc,C)
    xd = xs32 * decay_states.to(f32).permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bzcn,bzchp->bzhnp", *_f32(Bs), xd)
    del xd, xs32
    # 3. the inter-chunk recurrence, on the float32 state
    chunk_decay = torch.exp(A_cum[..., -1])                      # (B,H,nc)
    h_prevs, hcur = _recurrence(chunk_decay, states, h0, (bsz, h, n, p), f32,
                                x.device)                # (B,nc,H,N,P)
    del states
    # 4. off-diagonal part (the state entering each chunk): Cs · h_prev,
    # then ∘ state_decay
    state_decay = torch.exp(A_cum).to(cd)                         # (B,H,nc,C)
    y_off = torch.einsum("bzln,bzhnp->bzlhp",
                         *_f32(Cs, h_prevs.to(cd)))
    y_off = y_off * state_decay.to(f32).permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), hcur


def _ssd_groups(x, a, b_in, c_in, chunk, h0, cd):
    """``ssd_chunked``'s four steps with B and C in G > 1 groups: the
    heads split into (G, H / G), each product taken over its group's B or C,
    so nothing is repeated per head but the decay matrix L, which is the
    head's own anyway."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    hg = h // g
    f32 = _accum()
    nc = s // chunk
    xs32 = x.reshape(bsz, nc, chunk, g, hg, p).to(cd).to(f32)
    As = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2).to(f32)  # (B,H,nc,C)
    Bs = b_in.reshape(bsz, nc, chunk, g, n).to(cd)
    Cs = c_in.reshape(bsz, nc, chunk, g, n).to(cd)
    A_cum = torch.cumsum(As, dim=-1)                              # (B,H,nc,C)
    by_group = lambda t: t.permute(0, 2, 3, 1).reshape(bsz, nc, chunk, g, hg)
    # 1. diagonal blocks: (Cs·Bs) ∘ L per group, then · xs
    L = torch.exp(_segsum(As)).to(cd)                       # (B,H,nc,C,C)
    cb = torch.einsum("bzlgn,bzsgn->bgzls", *_f32(Cs, Bs))
    m = cb[:, :, None] * L.to(f32).view(bsz, g, hg, nc, chunk, chunk)
    y_diag = torch.einsum("bghzls,bzsghp->bzlghp", m, xs32)
    del cb, m, L
    # 2. chunk states (decay to the chunk's end): (decay ∘ xs), then · Bs
    decay_states = torch.exp(A_cum[..., -1:] - A_cum).to(cd)     # (B,H,nc,C)
    xd = xs32 * by_group(decay_states.to(f32))[..., None]
    states = torch.einsum("bzcgn,bzcghp->bzghnp", *_f32(Bs), xd)
    states = states.reshape(bsz, nc, h, n, p)
    del xd, xs32
    # 3. the inter-chunk recurrence, on the float32 state
    chunk_decay = torch.exp(A_cum[..., -1])                      # (B,H,nc)
    h_prevs, hcur = _recurrence(chunk_decay, states, h0, (bsz, h, n, p), f32,
                                x.device)
    del states
    # 4. off-diagonal part: Cs · h_prev per group, then ∘ state_decay
    state_decay = torch.exp(A_cum).to(cd)                         # (B,H,nc,C)
    y_off = torch.einsum("bzlgn,bzghnp->bzlghp", *_f32(
        Cs, h_prevs.to(cd).view(bsz, nc, g, hg, n, p)))
    y_off = y_off * by_group(state_decay.to(f32))[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), hcur


def ssd_scan(x, a, b_in, c_in, chunk: int = 64, h0=None,
             compute_dtype=torch.float32):
    """ssd_chunked with one loop over chunks, in float32: the same math,
    but the decay matrix L (B,H,C,C) and the states exist for one chunk at
    a time.  A ragged S (or S = 1) goes to ssd_chunked, as in JAX, and so
    do B and C in G > 1 groups."""
    if b_in.dim() == 4:
        if b_in.shape[2] > 1:
            return ssd_chunked(x, a, b_in, c_in, chunk=chunk, h0=h0,
                               compute_dtype=compute_dtype)
        b_in, c_in = b_in[:, :, 0], c_in[:, :, 0]
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if s == 1 or s % chunk:
        return ssd_chunked(x, a, b_in, c_in, chunk=chunk, h0=h0,
                           compute_dtype=compute_dtype)
    f32 = _accum()
    nc = s // chunk
    xs = x.reshape(bsz, nc, chunk, h, p).to(f32)
    As = a.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2).to(f32)  # (B,nc,H,C)
    Bs = b_in.reshape(bsz, nc, chunk, n).to(f32)
    Cs = c_in.reshape(bsz, nc, chunk, n).to(f32)
    hprev = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
             if h0 is None else h0)
    ys = []
    for xc, ac, bc, cc in zip(xs.unbind(1), As.unbind(1), Bs.unbind(1),
                              Cs.unbind(1)):
        a_cum = torch.cumsum(ac, dim=-1)                         # (B,H,C)
        L = torch.exp(_segsum(ac))                                # (B,H,C,C)
        m = torch.einsum("bln,bsn->bls", cc, bc)[:, None] * L
        y_diag = torch.einsum("bhls,bshp->blhp", m, xc)
        y_off = torch.einsum("bln,bhnp->blhp", cc, hprev) \
            * torch.exp(a_cum).permute(0, 2, 1)[..., None]
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (B,H,C)
        st = torch.einsum("bcn,bchp->bhnp", bc,
                          xc * decay_states.permute(0, 2, 1)[..., None])
        hprev = hprev * torch.exp(a_cum[..., -1])[..., None, None] + st
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y.to(x.dtype), hprev


def ssd_naive(x, a, b_in, c_in, h0=None):
    """Step-by-step oracle for ssd_chunked (B and C as (B,S,N) or in
    groups, (B,S,G,N))."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if b_in.dim() == 4:
        b_in, c_in = _per_head(b_in, h), _per_head(c_in, h)
    hst = (torch.zeros((bsz, h, n, p), dtype=L.ACCUM_DTYPE, device=x.device)
           if h0 is None else h0)
    ys = []
    for t in range(s):
        y, hst = _step(x[:, t], a[:, t], b_in[:, t], c_in[:, t], hst)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), hst


def _gated_rmsnorm(p, y, z, groups: int, eps: float):
    """Zamba2's gated RMSNorm: y·silu(z) in float32, each of ``groups``
    equal groups of channels normalised alone, times the weight, back in
    y's type."""
    f32 = L.ACCUM_DTYPE
    h = (y.to(f32) * F.silu(z.to(f32))).unflatten(-1, (groups, -1))
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h.flatten(-2) * p["w"]).to(y.dtype)


def mamba2_mixer(p, xin, dims: tuple[int, int, int, int], state=None,
                 chunk: int = 64, ssd_impl: str = "parallel",
                 compute_dtype=torch.float32, n_groups: int = 1,
                 d_on_x: bool = False, norm_groups: int = 0,
                 norm_eps: float = 1e-6):
    """The Mamba-2 block's mixer. xin: (B,S,d); dims = (d_inner, head_dim,
    d_state, d_conv). state: (conv_state (B, d_conv-1, d_inner+2GN), h
    (B,H,N,P)) or None. Returns (out (B,S,d), (conv_state, h)), both
    float32.  The defaults are the JAX package's mixer; Zamba2-7B's takes
    ``n_groups`` B/C groups, the conv bias ``p["conv_b"]`` where it is
    there, ``d_on_x`` and the gated norm in ``norm_groups`` groups at
    ``norm_eps`` (dt = softplus(dt + dt_bias) unclamped in both)."""
    d_inner, head_p, n, d_conv = dims
    b, s, _ = xin.shape
    n_heads = d_inner // head_p
    gn = n_groups * n
    zxbcdt = xin @ p["in_proj"].to(xin.dtype)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, n_heads],
                             dim=-1)
    # causal depthwise conv over (x, B, C)
    if state is None:
        conv_in = F.pad(xbc, (0, 0, d_conv - 1, 0))
    else:
        conv_in = torch.cat([state[0].to(xbc.dtype), xbc], dim=1)
    wconv = p["conv_w"].to(xbc.dtype)
    xbc_c = conv_in[:, 0:s] * wconv[0]
    for i in range(1, d_conv):       # JAX's sum(), in its order
        xbc_c = xbc_c + conv_in[:, i:i + s] * wconv[i]
    if "conv_b" in p:
        xbc_c = xbc_c + p["conv_b"].to(xbc_c.dtype)
    xbc_c = F.silu(xbc_c)
    xpart, b_in, c_in = torch.split(xbc_c, [d_inner, gn, gn], dim=-1)
    if n_groups > 1:
        b_in, c_in = (t.unflatten(-1, (n_groups, n)) for t in (b_in, c_in))
    dt_f = F.softplus(dt.to(L.ACCUM_DTYPE) + p["dt_bias"])        # (B,S,H)
    a = -torch.exp(p["a_log"]) * dt_f                             # log decay
    xr = xpart.reshape(b, s, n_heads, head_p)
    xh = xr * dt_f[..., None].to(xpart.dtype)
    h0 = None if state is None else state[1]
    ssd = ssd_scan if ssd_impl == "scan" else ssd_chunked
    with obs.span("ssm.ssd", chunk=min(chunk, s), groups=n_groups):
        y, h_fin = ssd(xh, a, b_in, c_in, chunk=min(chunk, s), h0=h0,
                       compute_dtype=compute_dtype)
    y = y + p["d_skip"][:, None].to(y.dtype) * (xr if d_on_x else xh)
    y = y.reshape(b, s, d_inner)
    if norm_groups:
        y = _gated_rmsnorm(p["norm"], y, z, norm_groups, norm_eps)
    else:
        y = L.rmsnorm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"].to(xin.dtype)
    new_conv = conv_in[:, conv_in.shape[1] - (d_conv - 1):]
    return out, (new_conv.to(L.ACCUM_DTYPE), h_fin)
