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
    through one launch of each kernel.  It trains on the card as on the
    CPU: both kernels' entry points are autograd Functions on the card
    (``kernels/ops.py``), whose backward is the paper's Algorithm 1 — the
    gradient of the join and of the group-by is ``relational_matmul`` over
    the transposed relation, and the gates' gradient the ``tuple_dot``
    kernel, one dot product an assignment.  Dropped assignments carry value
    0 through ``torch.where``, so, as JAX's ``mode="drop"``, they take no
    gradient.

Tokens are processed in GROUPS (GShard's group dimension): capacity and
ranks are group-local.  Both impls drop overflow beyond expert capacity
with identical rank-major priority, so their outputs match.

``impl="shard"`` — the relational plan with ENGINE SUPPORT at cluster
    scale, once ``set_moe_mesh`` has installed a mesh: each (data, model)
    rank routes its token shard, fills capacity buckets ONLY for the
    experts it owns (``_moe_sort_local``: the same two kernels under the
    owned-range relation, the other assignments parked in a drop bucket
    as non-matching join tuples), runs the local expert products and
    combines its partial sums; one ``all_reduce`` over 'model' replaces
    both the dispatch all-to-all and the one-hot einsums
    (``_moe_shard``, through ``local_map``, the counterpart of JAX's
    ``shard_map``).  Its capacity is JAX's: over all of a rank's tokens,
    not per group.  Without a mesh it runs the sort path, as the JAX
    package does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..obs import tracer as obs
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


def _count_drops(keep) -> None:
    """Traced, the counters ``moe.assignments`` and ``moe.dropped`` (the
    token-to-expert assignments past their expert's capacity, summed on
    the device); a forward that activation checkpointing recomputes in
    the backward is not counted again."""
    if obs.tracing() and not obs.in_backward():
        obs.inc("moe.assignments", keep.numel())
        obs.inc("moe.dropped", (~keep).sum())


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
        _count_drops(keep)
        oh_pos = F.one_hot(torch.where(keep, pos_tok, cap), cap + 1)[
            ..., :cap].to(torch.float32)                          # (G,g,C)
        d_r = mask_r.to(torch.float32)[..., :, None] * oh_pos[..., None, :]
        # out of place: combine's product saved d_r for the gates' gradient
        if dispatch is None:
            dispatch, combine = d_r, d_r * gates[..., r, None, None]
        else:
            dispatch = dispatch + d_r
            combine = combine + d_r * gates[..., r, None, None]
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
    one ``moe_dispatch`` over all E·G·cap slots.  GROUP BY token, SUM: the
    token-major relation (row t, col = the slot of each of its k
    assignments, value = gate, or 0 where the assignment dropped) times the
    expert outputs, as one ``relational_matmul`` that reads them in their
    own type and sums in float32 (JAX casts the gathered outputs to float32
    before the gate product too; the widening is exact, so no float32 copy
    is made).

    The slots are numbered expert-major, (e, G, c): the expert products run
    as one batched product over e on (E, G·cap, d), the layout the
    per-group einsum reaches by permuting its operands, so the same
    products without a copy, and the bucket buffer and the expert outputs
    reach both kernels (and, under autograd, their Functions) as the
    contiguous tensors the products make, not as copies."""
    n_groups, g, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(g, cfg)
    dev = xg.device
    slot_token, slot_live, pos = _sort_relation(idx, cap, e)
    first = (torch.arange(n_groups, device=dev) * g)[:, None, None]
    src = torch.where(slot_live, slot_token + first, 0).transpose(0, 1)
    x = xg.reshape(n_groups * g, d)
    buf = ops.moe_dispatch(x, src.reshape(-1).to(torch.int32),
                           slot_live.transpose(0, 1).reshape(-1)
                           .to(torch.float32))
    ys = _expert_ffn(p, buf.reshape(e, n_groups * cap, d))
    keep = pos < cap
    _count_drops(keep)
    slot = ((idx * n_groups + torch.arange(n_groups, device=dev)[:, None,
                                                                  None])
            * cap + pos)
    rows = torch.arange(n_groups * g, dtype=torch.int32,
                        device=dev).repeat_interleave(k)
    cols = torch.where(keep, slot, 0).reshape(-1).to(torch.int32)
    vals = torch.where(keep, gates, 0.0).reshape(-1).to(torch.float32)
    out = ops.relational_matmul(rows, cols, vals, ys.reshape(-1, d),
                                n_groups * g)
    return out.to(xg.dtype).reshape(n_groups, g, d)


# ---------------------------------------------------------------------------
# relational representation with ENGINE SUPPORT: the expert-owner plan
# ---------------------------------------------------------------------------
# The paper's conclusion — the relational representation needs engine
# support (sort-based aggregation, §8) — repeats at cluster scale: under
# pure sharding propagation the sort/scatter plan communicates *more* than
# the one-hot einsum.  local_map is that engine support: each (data,
# model) rank routes its token shard, fills capacity buckets ONLY for the
# experts it owns, runs the local expert GEMMs, and partial-combines; a
# single all_reduce over 'model' replaces both the dispatch all-to-all and
# the one-hot einsums.

_SHARD_CTX: dict = {"mesh": None, "dp": None}


def set_moe_mesh(mesh, dp_axes):
    """Install the mesh for impl='shard' (the dry-run and phase 15 call
    this); ``mesh=None`` takes it away."""
    _SHARD_CTX["mesh"] = mesh
    _SHARD_CTX["dp"] = dp_axes


def _moe_sort_local(p_wi, p_wg, p_wo, x, cfg, gates, idx, e_lo, e_loc,
                    cap):
    """Bucket-fill + expert GEMM + combine for the local expert range
    [e_lo, e_lo + e_loc) over all of x's tokens (one group).  Slots
    outside the range drop like non-matching join tuples: their
    assignments go to a drop bucket, expert e_loc, which fills no slot.
    x (g, d); gates / idx (g, k); the weights (e_loc, ...).  The bucket
    fill is one ``moe_dispatch``, the combine one ``relational_matmul``
    over the owned, kept assignments (the others carry value 0)."""
    g, d = x.shape
    dev = x.device
    loc = idx - e_lo
    owned = (loc >= 0) & (loc < e_loc)
    loc = torch.where(owned, loc, e_loc)              # park in drop bucket
    slot_token, slot_live, pos = _sort_relation(loc[None], cap, e_loc + 1)
    slot_token, slot_live, pos = (slot_token[0, :e_loc],
                                  slot_live[0, :e_loc], pos[0])
    src = torch.where(slot_live, slot_token, 0)
    buf = ops.moe_dispatch(x, src.reshape(-1).to(torch.int32),
                           slot_live.reshape(-1).to(torch.float32))
    ys = _expert_ffn({"wi": p_wi, "wg": p_wg, "wo": p_wo},
                     buf.reshape(e_loc, cap, d))
    keep = owned & (pos < cap)
    rows = torch.arange(g, dtype=torch.int32,
                        device=dev).repeat_interleave(cfg.top_k)
    cols = torch.where(keep, loc * cap + pos, 0).reshape(-1).to(torch.int32)
    vals = torch.where(keep, gates, 0.0).reshape(-1).to(torch.float32)
    out = ops.relational_matmul(rows, cols, vals, ys.reshape(-1, d), g)
    return out.to(x.dtype)


class _PSum(torch.autograd.Function):
    """Sum over a process group (JAX's ``psum``) into a value every rank
    holds alike; each rank's share takes the output's gradient as it is
    (JAX's transpose of a psum into a replicated output)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_shard(p, x, cfg: MoEConfig):
    """Expert-owner execution over the installed mesh. x: (T, d) flat
    tokens, a DTensor on the mesh or a tensor every rank holds whole (then
    taken as replicated, and the output returned whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..launch.mesh import axis_size

    mesh, dp = _SHARD_CTX["mesh"], _SHARD_CTX["dp"]
    mp = axis_size(mesh, "model")
    e_loc = cfg.n_experts // mp
    t = x.shape[0]
    dp_n = axis_size(mesh, dp)
    t_loc = t // dp_n if t % dp_n == 0 else t
    cap = _capacity(t_loc, cfg)
    names = tuple(mesh.mesh_dim_names)

    def local(x_loc, router, wi, wg, wo):
        gates, idx, _ = _route({"router": router}, x_loc, cfg)
        e_lo = mesh.get_local_rank("model") * e_loc
        partial = _moe_sort_local(wi, wg, wo, x_loc, cfg, gates, idx,
                                  e_lo, e_loc, cap)
        return _PSum.apply(partial, mesh.get_group("model"))

    whole = not isinstance(x, DTensor)
    args = [x, p["router"], p["wi"], p["wg"], p["wo"]]
    if whole:
        args = [DTensor.from_local(a, mesh, [Replicate()] * len(names),
                                   run_check=False) for a in args]
    # local_map reads a tuple as one entry an output and a list as the
    # placements of one tensor
    x_spec = [Shard(0) if n in dp and t % dp_n == 0 else Replicate()
              for n in names]
    rep = [Replicate()] * len(names)
    experts = [Shard(0) if n == "model" else Replicate() for n in names]
    out = local_map(local, out_placements=x_spec,
                    in_placements=(x_spec, rep, experts, experts, experts),
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    return out.full_tensor() if whole else out


def moe_ffn(p, x, cfg: MoEConfig):
    """x: (T, d) flat tokens → (out (T, d), aux_loss)."""
    t, d = x.shape
    g = min(cfg.group_size, t)
    if t % g:
        g = t                                        # tiny/odd batches
    xg = x.reshape(t // g, g, d)
    gates, idx, aux = _route(p, xg, cfg)
    if cfg.impl == "shard" and _SHARD_CTX["mesh"] is not None:
        out = _moe_shard(p, x, cfg)
    elif cfg.impl == "einsum":
        out = _moe_einsum(p, xg, cfg, gates, idx).reshape(t, d)
    elif cfg.impl in ("sort", "shard"):              # shard falls back
        out = _moe_sort(p, xg, cfg, gates, idx).reshape(t, d)
    else:
        raise ValueError(cfg.impl)
    if cfg.n_shared:
        sh = p["shared"]
        h = (x @ cdt(sh["wi"])) * F.silu(x @ cdt(sh["wg"]))
        out = out + h @ cdt(sh["wo"])
    return out, aux
