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


def tuple_dot(a: torch.Tensor, rows: torch.Tensor, b: torch.Tensor,
              cols: torch.Tensor) -> torch.Tensor:
    """One dot product a tuple (an SDDMM): out[t] = Σ_j a[rows[t], j] ·
    b[cols[t], j], summed in float32 (float64 where a and b are, an
    oracle), a and b each read in its own type.  A tuple whose row lies
    outside 0..a.shape[0]-1 (the padding, ``rows == a.shape[0]``) gives 0.

    The gradient of ``relational_matmul`` with respect to its values
    (a = dOut, b = b) and of ``moe_dispatch`` with respect to its gates
    (a = dOut on the slots, b = x)."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    out = torch.zeros(rows.shape, dtype=acc, device=b.device)
    live = (rows >= 0) & (rows < a.shape[0])
    r = torch.where(live, rows, 0).long()
    if a.shape[0]:
        dots = (a[r].to(acc) * b[cols.long()].to(acc)).sum(dim=-1)
        out = torch.where(live, dots, out)
    return out


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


# ---------------------------------------------------------------------------
# The float32 flash kernel's arithmetic, emulated part by part

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as the kernel's ``to_tf32`` rounds: half a unit of the
    13 dropped bits added to the int32 word, then those bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_parts(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """x as ``parts`` TF32 words, the largest first, each the rounded rest
    of the ones before it (the subtractions are exact in float32):
    |x - sum| <= 2^-11 |x| for one part, 2^-22 |x| for two (hi, lo),
    2^-33 |x| for three (hi, mid, lo).  ``parts=0`` is x itself, unsplit."""
    if parts == 0:
        return [x]
    out, rest = [], x
    for _ in range(parts):
        out.append(to_tf32(rest))
        rest = rest - out[-1]
    return out


#: the products a k-step takes, as (part of a, part of b), smallest first:
#: the kernel's 3xTF32 (lo·hi, hi·lo, hi·hi); 6 of 3 parts, every one above
#: 2^-24 |a b|; one unsplit float32 product (exact, as if the tensor core
#: took float32 operands).
PRODUCTS = {0: ((0, 0),),
            2: ((1, 0), (0, 1), (0, 0)),
            3: ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))}


_TILE = 64                  # the kernel's keys a tile


def round_f32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 → float32 to nearest (IEEE) or toward zero (how the tensor
    cores round a wgmma's float32 accumulation)."""
    y = x.to(torch.float32)
    if mode == "zero":
        over = y.to(x.dtype).abs() > x.abs()
        y = torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)
    elif mode != "nearest":
        raise ValueError(f"rounding {mode!r}: 'nearest' or 'zero'")
    return y


def _chain(acc, a_parts, b_parts, parts: int, mode: str, apart: bool = False,
           kstep: int = 8):
    """acc (float32) plus Σ_k a[..., k] b[k, ...] as the kernel issues it:
    k-steps of ``kstep`` in order, each the PRODUCTS of their parts, one
    wgmma each; a wgmma's products are exact and the sum with its
    accumulator is rounded once, by ``mode``.  ``apart``: the products
    other than hi·hi go to an accumulator of their own, started from zero
    and added to the result at the end (to nearest)."""
    small = torch.zeros_like(acc) if apart else None
    for k0 in range(0, a_parts[0].shape[-1], kstep):
        for i, j in PRODUCTS[parts]:
            term = a_parts[i][..., k0:k0 + kstep].double() @ \
                b_parts[j][..., k0:k0 + kstep, :].double()
            if apart and (i, j) != (0, 0):
                small = round_f32(small.double() + term, mode)
            else:
                acc = round_f32(acc.double() + term, mode)
    return acc if small is None else acc + small


def flash_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: float | None = None, *, parts: int = 2,
                             s_round: str = "zero", pv_round: str = "zero",
                             pv_tile: bool = True, s_apart: bool = False,
                             pv_apart: bool = False,
                             softmax_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """The float32 kernel's arithmetic (``csrc/flash_attention.cu``) in plain
    PyTorch,
    with each of its sources of error a knob, so that its share of the
    kernel's error can be read alone:

    - ``parts``: each operand of S = q kᵀ and of P·V split into that many
      TF32 parts (2: the kernel's hi and lo; 3: hi, mid, lo; 0: float32
      operands, exact products);
    - ``s_round`` / ``pv_round``: how a wgmma's float32 accumulation is
      rounded ("zero": truncated, as the tensor cores do; "nearest");
    - ``pv_tile``: each key tile's P·V summed from zero and added to the
      rescaled O in float32 registers (one FMA, to nearest), instead of
      one accumulator carried across all tiles (False: the kernel's
      design before the repair this emulation measured for);
    - ``s_apart`` / ``pv_apart`` (the latter with ``pv_tile``): the small
      products (all but hi·hi) of S's / a tile's P·V summed in an
      accumulator of their own, added at the end;
    - ``softmax_dtype``: the online softmax (exp, the running max and sum,
      O's rescaling and O / l) in float32 (the kernel's) or float64.

    S is summed per 64-key tile from zero, as the kernel sums it; the
    online softmax runs tile by tile.  Float32 operands (B, Hq, S, D) /
    (B, Hkv, S, D) / (B, Hkv, S, Dv); returns float32.  Slow (a PyTorch
    op a wgmma): for reading the error, not for use."""
    if pv_apart and not pv_tile:
        raise ValueError("pv_apart sums a tile's small products apart: "
                         "it needs pv_tile")
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    sd = softmax_dtype
    out = torch.empty((b, hq, s, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for i in range(b):                     # one batch row at a time: memory
        qp = tf32_parts(q[i].float(), parts)
        kp = [t.repeat_interleave(group, dim=0).transpose(-1, -2)
              for t in tf32_parts(k[i].float(), parts)]
        vp = [t.repeat_interleave(group, dim=0)
              for t in tf32_parts(v[i].float(), parts)]
        scores = _chain(torch.zeros((hq, s, s), dtype=torch.float32,
                                    device=q.device), qp, kp, parts,
                        s_round, s_apart)
        m = torch.full((hq, s, 1), -1e30, dtype=sd, device=q.device)
        l = torch.zeros((hq, s, 1), dtype=sd, device=q.device)
        o = torch.zeros((hq, s, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
        for k0 in range(0, s, _TILE):
            x = (scores[..., k0:k0 + _TILE] * scale).to(sd)
            if causal:
                keys = torch.arange(k0, min(k0 + _TILE, s), device=q.device)
                x = torch.where(keys[None] <= rows, x, -1e30)
            mn = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - mn)
            p = torch.exp(x - mn)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = mn
            pp = tf32_parts(p.to(torch.float32), parts)
            vt = [t[:, k0:k0 + _TILE] for t in vp]
            if pv_tile:                      # o = fma(o, alpha, tile's P·V)
                part = _chain(torch.zeros_like(o), pp, vt, parts, pv_round,
                              pv_apart)
                o = (o.double() * alpha.double() + part.double()).to(
                    torch.float32)
            else:
                o = _chain((o.to(sd) * alpha).to(torch.float32), pp, vt,
                           parts, pv_round)
        if sd == torch.float32:             # the kernel's o · (1 / l)
            out[i] = o * (1.0 / l)
        else:
            out[i] = (o.to(sd) / l).to(torch.float32)
    return out


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


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                   do: torch.Tensor, ds_fin: torch.Tensor | None = None,
                   want_ds0: bool = True):
    """(dr, dk, dv, dw, du, ds0) of ``rwkv6_scan(r, k, v, w, u, s0)`` for
    the output gradient ``do`` and the final state's ``ds_fin`` (None: 0):
    an explicit reverse-time loop, not autograd.  With G_t = dL/dS_t,
    G_T = ds_fin, going back from t = T:

        dr_t = S_{t-1} do_t + u ∘ k_t (v_t·do_t)
        dk_t = G_t v_t + u ∘ r_t (v_t·do_t)
        dv_t = G_tᵀ k_t + (Σ_i u_i r_t[i] k_t[i]) do_t
        dw_t = rowsum(G_t ∘ S_{t-1});   du += r_t ∘ k_t (v_t·do_t)
        G_{t-1} = diag(w_t) G_t + r_t do_tᵀ;   ds0 = G_0

    S_{t-1} is never recovered by dividing by w_t (which may underflow):
    the forward keeps S every 64 steps, and each chunk's states are
    recomputed from its checkpoint on the way back, so no more than
    S / 64 + 64 states are alive at once (autograd of ``rwkv6_scan`` keeps
    all S: 17 GB a layer in float64 at RWKV-6 7B's training microbatch).
    Shapes as ``rwkv6_scan``'s, (BH, S, N) or (B, H, S, N); du in u's
    leading shape (per row of state: autograd sums it over an expand), ds0
    in s0's (None unless ``want_ds0``).  In float32, float64 where s0 or do
    is (the card's oracle)."""
    acc = torch.promote_types(torch.promote_types(s0.dtype, do.dtype),
                              torch.float32)
    r, k, v, w, u, s, do = (t.to(acc) for t in (r, k, v, w, u, s0, do))
    lead = torch.broadcast_shapes(r.shape[:-2], u.shape[:-1],
                                  s.shape[:-2])
    seq, chunk = r.shape[-2], 64
    ckpts = []
    for t in range(seq):
        if t % chunk == 0:
            ckpts.append(s)
        s = w[..., t, :, None] * s + k[..., t, :, None] * v[..., t, None, :]
    g = (torch.zeros_like(s) if ds_fin is None
         else ds_fin.to(acc).expand_as(s).clone())
    dr, dk, dv, dw = (torch.empty((*lead, seq, r.shape[-1]), dtype=acc,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((*lead, r.shape[-1]), dtype=acc, device=r.device)
    c = (v * do).sum(-1)                                  # v_t·do_t
    for ci in reversed(range(len(ckpts))):
        t0, t1 = ci * chunk, min(seq, (ci + 1) * chunk)
        s, hist = ckpts[ci], []
        for t in range(t0, t1):                # S_{t-1} for t in the chunk
            hist.append(s)
            s = w[..., t, :, None] * s \
                + k[..., t, :, None] * v[..., t, None, :]
        for t in reversed(range(t0, t1)):
            sp, ct = hist[t - t0], c[..., t, None]
            r_t, k_t, v_t, w_t, do_t = (x[..., t, :] for x in (r, k, v, w,
                                                                do))
            dr[..., t, :] = torch.einsum("...ij,...j->...i", sp, do_t) \
                + u * k_t * ct
            dk[..., t, :] = torch.einsum("...ij,...j->...i", g, v_t) \
                + u * r_t * ct
            dv[..., t, :] = torch.einsum("...ij,...i->...j", g, k_t) \
                + (u * r_t * k_t).sum(-1, keepdim=True) * do_t
            dw[..., t, :] = (g * sp).sum(-1)
            du = du + r_t * k_t * ct
            g = w_t[..., :, None] * g + r_t[..., :, None] * do_t[..., None, :]
    return dr, dk, dv, dw, du, g if want_ds0 else None


def _excl_prefix(w: torch.Tensor) -> torch.Tensor:
    """Π_{m<t} w_m along the step axis (-2), exclusive, by running
    products: never a quotient and never a logarithm (w may be 0)."""
    out, run = torch.empty_like(w), torch.ones_like(w[..., 0, :])
    for t in range(w.shape[-2]):
        out[..., t, :] = run
        run = run * w[..., t, :]
    return out


def _excl_suffix(w: torch.Tensor) -> torch.Tensor:
    """Π_{m>t} w_m along the step axis (-2), exclusive, by running
    products."""
    out, run = torch.empty_like(w), torch.ones_like(w[..., 0, :])
    for t in reversed(range(w.shape[-2])):
        out[..., t, :] = run
        run = run * w[..., t, :]
    return out


def rwkv6_scan_bwd_chunked(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           s0: torch.Tensor, do: torch.Tensor,
                           ds_fin: torch.Tensor | None = None,
                           want_ds0: bool = True, chunk: int = 64):
    """``rwkv6_scan_bwd`` computed the way the ``rwkv6_scan_bwd`` kernel
    computes it: the plain twin of its algebra, for the tests (the CPU route
    of ``ops`` keeps the sequential ``rwkv6_scan_bwd``).  Same arguments
    and results; ``chunk`` a multiple of 16 (the kernel's is 64).

    1. Chunk boundaries (the kernel's first launch).  The state S before
       each chunk of ``chunk`` steps, from s0, and G after it, from ds_fin:
       S ← diag(Π w) S + K̃ᵀ V with K̃_s = k_s Π_{m>s} w_m, and G ← diag(Π w)
       G + R̃ᵀ dO with R̃_s = r_s Π_{m<s} w_m (products inside the chunk).
       ds0 is G before chunk 0.  Past S the steps are padding: r, k, v and
       do 0, w 1, which leaves S and G as they are.
    2. Each chunk alone (the second launch), in sub-chunks of 16 steps.  G at each sub-chunk's end by the same update from the
       chunk's end, then, forward, P (the state before each sub-chunk) and
       with the sub-chunk's P and G the boundary products Y = dO Pᵀ, Z = V
       Gᵀ, U = K̂ G (K̂_t = k_t Π_{t<m} w_m inside the sub-chunk), M = V
       dOᵀ and bb = rowsum(P ∘ G).  Inside the sub-chunk, with D(s, t) =
       Π_{s<m<t} w_m (a running product, 1 for t = s + 1), pre_t = Π_{m<t}
       w_m and suf_t = Π_{m>t} w_m:

         dr_t = pre_t Y_t + Σ_{s<t} D(s,t) k_s M[s,t] + u k_t M[t,t]
         dk_t = suf_t Z_t + Σ_{s>t} D(t,s) r_s M[t,s] + u r_t M[t,t]
         dv_t = U_t + Σ_{s>t} Bm[s,t] do_s + (Σ_i u r_t k_t) do_t,
                Bm[s,t] = Σ_i D(t,s) r_s k_t
         dw_t = pre_t suf_t bb + pre_t Σ_{s>t} D(t,s) r_s Y_s
                + suf_t Σ_{s<t} D(s,t) k_s Z_s
                + Σ_{s<t<s'} D(s,t) D(t,s') k_s r_s' M[s,s']

       dw_t = rowsum(G_t ∘ S_{t-1}) split into {boundary, in-sub-chunk}
       parts of both factors: none of the four holds w_t, so no decay is
       ever divided out (w = exp(-exp(x)) is exactly 0 in float32 for x ≳
       4.6).  The last sum runs as Q_t[s'] = Σ_{s<t} D(s,t) k_s M[s,s'],
       Q_{t+1} = w_t Q_t + k_t M[t], whose diagonal Q_t[t] is dr's sum.
    3. du = Σ_t r_t k_t M[t,t], summed a chunk at a time.
    """
    acc = torch.promote_types(torch.promote_types(s0.dtype, do.dtype),
                              torch.float32)
    r, k, v, w, u, s0, do = (t.to(acc) for t in (r, k, v, w, u, s0, do))
    lead = torch.broadcast_shapes(r.shape[:-2], u.shape[:-1],
                                  s0.shape[:-2])
    seq, n = r.shape[-2:]
    r, k, v, w, do = (t.expand(*lead, seq, n) for t in (r, k, v, w, do))
    u = u.expand(*lead, n)
    sub = 16
    nc, ns = -(-seq // chunk), chunk // sub
    pad = nc * chunk - seq

    def chunks(t, fill):
        t = torch.cat([t, t.new_full((*lead, pad, n), fill)], dim=-2)
        return t.reshape(*lead, nc, chunk, n)

    r, k, v, do = (chunks(t, 0.0) for t in (r, k, v, do))
    w = chunks(w, 1.0)
    mt = lambda x: x.transpose(-1, -2)

    # 1. the state before each chunk, G after it
    decay = torch.prod(w, dim=-2)                       # (..., nc, n)
    k_til = k * _excl_suffix(w)
    r_til = r * _excl_prefix(w)
    s, starts = s0.expand(*lead, n, n), []
    for c in range(nc):
        starts.append(s)
        s = decay[..., c, :, None] * s + mt(k_til[..., c, :, :]) \
            @ v[..., c, :, :]
    g = (torch.zeros((*lead, n, n), dtype=acc, device=r.device)
         if ds_fin is None else ds_fin.to(acc).expand(*lead, n, n))
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = g
        g = decay[..., c, :, None] * g + mt(r_til[..., c, :, :]) \
            @ do[..., c, :, :]
    ds0 = g if want_ds0 else None

    # 2. every chunk at once, in sub-chunks: (..., nc, ns, sub, n)
    sc = lambda t: t.reshape(*lead, nc, ns, sub, n)
    r, k, v, w, do = (sc(t) for t in (r, k, v, w, do))
    pre, suf = _excl_prefix(w), _excl_suffix(w)
    dec = torch.prod(w, dim=-2)                          # (..., nc, ns, n)
    r_hat, k_hat = r * pre, k * suf
    gs = [None] * ns
    gs[-1] = torch.stack(ends, dim=-3)                   # (..., nc, n, n)
    for q in reversed(range(1, ns)):
        gs[q - 1] = dec[..., q, :, None] * gs[q] \
            + mt(r_hat[..., q, :, :]) @ do[..., q, :, :]
    p = torch.stack(starts, dim=-3)
    ys, zs, us, bbs = [], [], [], []
    for q in range(ns):
        ys.append(do[..., q, :, :] @ mt(p))
        zs.append(v[..., q, :, :] @ mt(gs[q]))
        us.append(k_hat[..., q, :, :] @ gs[q])
        bbs.append((p * gs[q]).sum(-1))
        p = dec[..., q, :, None] * p + mt(k_hat[..., q, :, :]) \
            @ v[..., q, :, :]
    y, z, uu = (torch.stack(x, dim=-3) for x in (ys, zs, us))
    bb = torch.stack(bbs, dim=-2)                        # (..., nc, ns, n)
    m = v @ mt(do)                                       # M[s, t]
    ub = u[..., None, None, :]
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    q_run = torch.zeros((*r.shape[:-2], n, sub), dtype=acc, device=r.device)
    b_run = torch.zeros_like(r[..., 0, :])
    at = lambda x, t: x[..., t, :]
    for t in range(sub):
        mtt = m[..., t, t, None]
        omega = torch.ones_like(b_run)
        c_t, d_t, e_t = (torch.zeros_like(b_run) for _ in range(3))
        for s2 in range(t + 1, sub):
            yy = omega * at(r, s2)
            c_t = c_t + yy * m[..., t, s2, None]
            d_t = d_t + yy * at(y, s2)
            e_t = e_t + yy * q_run[..., s2]
            omega = omega * at(w, s2)
        dr[..., t, :] = at(pre, t) * at(y, t) + q_run[..., t] \
            + ub * at(k, t) * mtt
        dk[..., t, :] = at(suf, t) * at(z, t) + c_t + ub * at(r, t) * mtt
        dw[..., t, :] = at(pre, t) * at(suf, t) * bb + at(pre, t) * d_t \
            + at(suf, t) * b_run + e_t
        q_run = at(w, t)[..., None] * q_run \
            + at(k, t)[..., None] * m[..., t, None, :]
        b_run = at(w, t) * b_run + at(k, t) * at(z, t)
    bm = torch.zeros_like(m)                             # Bm[s, t]
    for t in range(sub):
        omega = torch.ones_like(b_run)
        bm[..., t, t] = (ub * at(r, t) * at(k, t)).sum(-1)
        for s2 in range(t + 1, sub):
            bm[..., s2, t] = (omega * at(r, s2) * at(k, t)).sum(-1)
            omega = omega * at(w, s2)
    dv = uu + mt(torch.tril(bm)) @ do
    du = (r * k * torch.diagonal(m, dim1=-2, dim2=-1)[..., None]).sum(
        dim=(-4, -3, -2))
    flat = lambda x: x.reshape(*lead, nc * chunk, n)[..., :seq, :]
    return (flat(dr), flat(dk), flat(dv), flat(dw), du, ds0)
