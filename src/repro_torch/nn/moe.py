"""Mixture-of-Experts with the paper's two matrix representations, PyTorch
port of ``repro.nn.moe``.

The router's output *is* the paper's relation ``{[i, j, v]}``: token i is
assigned to expert j with gate value v.  Both execution strategies of the
JAX package are here, selected by ``MoEConfig.impl``:

``impl="einsum"`` — the ARRAY representation (paper Section 5): the
    assignment is materialised per token group as a dense one-hot
    dispatch/combine tensor (G, g, E, C) and dispatch and combine are
    einsums (GShard-style): O(E·C/k) redundant multiply-adds per token, the
    array analogue of the paper's join blow-up (Fig. 5).

``impl="sort"`` — the RELATIONAL representation (paper Section 4): the
    assignment stays a sparse relation; the per-expert rank comes from a
    stable sort (the paper's §8 sort-based aggregation), dispatch is the
    *join* (each capacity slot gathers its token's row: the ``moe_dispatch``
    kernel on the card) and combine is the *group-by token, sum* (the
    ``relational_matmul`` kernel, with the gates as the relation's values).
    The JAX package ``vmap``s the groups; here every group's slots go
    through one launch of each kernel.

Tokens are processed in GROUPS (GShard's group dimension): capacity and
ranks are group-local.  Both impls drop overflow beyond expert capacity
with identical rank-major priority, so their outputs match.

``impl="shard"`` without a mesh runs the sort path, as the JAX package
does without one; the expert-parallel ``_moe_shard`` (and ``set_moe_mesh``)
come with ROADMAP.md queue 1, item 18.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import cdt, dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                 # per-expert hidden
    n_shared: int = 0         # shared experts (DeepSeek)
    capacity_factor: float = 1.25
    router_softmax: str = "pre"   # "pre": softmax→topk (DeepSeek);
                                  # "post": topk→softmax (DBRX/Mixtral)
    impl: str = "einsum"
    group_size: int = 2048


def init_moe(gen: torch.Generator, cfg: MoEConfig, lead=()):
    """The JAX ``init_moe`` tree; ``lead`` prepends a stacked-layer axis."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (*lead, d, e)),
        "wi": dense_init(gen, (*lead, e, d, f)),
        "wg": dense_init(gen, (*lead, e, d, f)),
        "wo": dense_init(gen, (*lead, e, f, d)),
    }
    if cfg.n_shared:
        p["shared"] = {
            "wi": dense_init(gen, (*lead, d, cfg.n_shared * f)),
            "wg": dense_init(gen, (*lead, d, cfg.n_shared * f)),
            "wo": dense_init(gen, (*lead, cfg.n_shared * f, d)),
        }
    return p


def _route(p, x, cfg: MoEConfig):
    """Top-k routing over the tokens of x (..., d). Returns (gates, idx,
    aux_loss)."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    if cfg.router_softmax == "pre":
        gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
        gates = gates / gates.sum(dim=-1, keepdim=True)
    else:
        top_logits, idx = torch.topk(logits, cfg.top_k, dim=-1)
        gates = torch.softmax(top_logits, dim=-1)
    # Switch-style load-balancing aux loss (fraction × mean prob)
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)
    ce = F.one_hot(idx, cfg.n_experts).to(torch.float32).sum(dim=-2).mean(
        dim=tuple(range(idx.dim() - 1)))
    aux = cfg.n_experts * (me * ce).sum() / cfg.top_k
    return gates, idx, aux


def _capacity(group: int, cfg: MoEConfig) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _expert_ffn(p, xs):
    """xs: (..., E, C, d) → SwiGLU per expert."""
    h = torch.einsum("...ecd,edf->...ecf", xs, cdt(p["wi"]))
    g = torch.einsum("...ecd,edf->...ecf", xs, cdt(p["wg"]))
    return torch.einsum("...ecf,efd->...ecd", h * F.silu(g), cdt(p["wo"]))


# ---------------------------------------------------------------------------
# array representation: dense one-hot dispatch/combine (GShard), grouped
# ---------------------------------------------------------------------------

def _moe_einsum(p, xg, cfg: MoEConfig, gates, idx):
    """xg: (G, g, d); gates/idx: (G, g, k)."""
    _, g, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(g, cfg)
    pos_offset = torch.zeros(idx.shape[:1] + (e,), dtype=torch.int64,
                             device=xg.device)                   # (G, E)
    dispatch = combine = None
    for r in range(k):
        mask_r = F.one_hot(idx[..., r], e)                         # (G,g,E)
        pos_r = torch.cumsum(mask_r, dim=1) - 1 + pos_offset[:, None]
        pos_offset = pos_offset + mask_r.sum(dim=1)
        pos_tok = (mask_r * pos_r).sum(dim=-1)                    # (G, g)
        keep = pos_tok < cap
        oh_pos = F.one_hot(torch.where(keep, pos_tok, cap), cap + 1)[
            ..., :cap].to(torch.float32)                          # (G,g,C)
        d_r = mask_r.to(torch.float32)[..., :, None] * oh_pos[..., None, :]
        if dispatch is None:
            dispatch, combine = d_r, d_r * gates[..., r, None, None]
        else:
            dispatch += d_r
            combine += d_r * gates[..., r, None, None]
    xs = torch.einsum("gsec,gsd->gecd", dispatch.to(xg.dtype), xg)
    ys = _expert_ffn(p, xs)
    return torch.einsum("gsec,gecd->gsd", combine.to(xg.dtype), ys)


# ---------------------------------------------------------------------------
# relational representation: sort (join) + segment sum (group-by), grouped
# ---------------------------------------------------------------------------

def _sort_relation(idx, cap: int, e: int):
    """The rank-major relation of each group, sorted by expert (stably, so
    the einsum path's drop priority holds), and the capacity slots it
    fills.  idx: (G, g, k).  Returns (slot_token (G, E, cap) — the token
    each slot takes —, slot_live (G, E, cap), pos (G, g, k) — each
    assignment's rank inside its expert)."""
    n_groups, g, k = idx.shape
    dev = idx.device
    expert_s = idx.transpose(1, 2).reshape(n_groups, k * g)      # (G, S)
    order = torch.argsort(expert_s, dim=1, stable=True)
    expert_sorted = torch.gather(expert_s, 1, order)
    token_sorted = order % g                  # the relation's token column
    counts = torch.zeros((n_groups, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, expert_s, torch.ones_like(expert_s))
    seg_start = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(k * g, device=dev)[None]
    pos_sorted = rank - torch.gather(seg_start, 1, expert_sorted)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    pos = pos.reshape(n_groups, k, g).transpose(1, 2)             # (G, g, k)
    c = torch.arange(cap, device=dev)
    slot_live = c < counts[..., None]                              # (G,E,cap)
    src = (seg_start[..., None] + c).clamp(max=k * g - 1)
    slot_token = torch.gather(token_sorted, 1,
                              src.reshape(n_groups, -1)).reshape(src.shape)
    return slot_token, slot_live, pos


def _moe_sort(p, xg, cfg: MoEConfig, gates, idx):
    """Every group's relation at once. xg: (G, g, d); gates/idx: (G, g, k).

    JOIN: slot (e, c) of group G takes token ``token_sorted[seg_start[e] +
    c]`` with gate 1 while c < min(counts[e], cap), else row 0 with gate 0
    — the JAX scatter-add of ``x[token_sorted]`` into a zero buffer, as
    one ``moe_dispatch`` over all G·E·cap slots.  GROUP BY token, SUM: the
    token-major relation (row t, col = the slot of each of its k
    assignments, value = gate, or 0 where the assignment dropped) times the
    expert outputs, as one ``relational_matmul`` that reads them in their
    own type and sums in float32 (JAX casts the gathered outputs to float32
    before the gate product too; the widening is exact, so no float32 copy
    is made)."""
    n_groups, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(g, cfg)
    dev = xg.device
    slot_token, slot_live, pos = _sort_relation(idx, cap, e)
    first = (torch.arange(n_groups, device=dev) * g)[:, None, None]
    src = torch.where(slot_live, slot_token + first, 0)
    x = xg.reshape(n_groups * g, d)
    buf = ops.moe_dispatch(x, src.reshape(-1).to(torch.int32),
                           slot_live.reshape(-1).to(torch.float32))
    ys = _expert_ffn(p, buf.reshape(n_groups, e, cap, d))
    keep = pos < cap
    slot = ((torch.arange(n_groups, device=dev)[:, None, None] * e + idx)
            * cap + pos)
    rows = torch.arange(n_groups * g, dtype=torch.int32,
                        device=dev).repeat_interleave(k)
    cols = torch.where(keep, slot, 0).reshape(-1).to(torch.int32)
    vals = torch.where(keep, gates, 0.0).reshape(-1).to(torch.float32)
    out = ops.relational_matmul(rows, cols, vals,
                                ys.reshape(n_groups * e * cap, d),
                                n_groups * g)
    return out.to(xg.dtype).reshape(n_groups, g, d)


def moe_ffn(p, x, cfg: MoEConfig):
    """x: (T, d) flat tokens → (out (T, d), aux_loss)."""
    t, d = x.shape
    g = min(cfg.group_size, t)
    if t % g:
        g = t                                        # tiny/odd batches
    xg = x.reshape(t // g, g, d)
    gates, idx, aux = _route(p, xg, cfg)
    if cfg.impl == "einsum":
        out = _moe_einsum(p, xg, cfg, gates, idx).reshape(t, d)
    elif cfg.impl in ("sort", "shard"):              # shard: no mesh here
        out = _moe_sort(p, xg, cfg, gates, idx).reshape(t, d)
    else:
        raise ValueError(cfg.impl)
    if cfg.n_shared:
        sh = p["shared"]
        h = (x @ cdt(sh["wi"])) * F.silu(x @ cdt(sh["wg"]))
        out = out + h @ cdt(sh["wo"])
    return out, aux
