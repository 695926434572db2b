"""Mixture-of-Experts routing, dispatch and combine transpiled to SQL
(PyTorch port of ``repro.db.zoo.moe_to_sql``).

The router's output *is* the paper's relation ``{[i, j, v]}`` (token i →
expert j with gate v, see ``nn/moe.py``); this module expresses the whole
layer over the zoo IR so ``core.sqlgen`` renders it as one WITH query and
``SQLEngine`` runs it inside sqlite/duckdb:

* **routing** — ``Softmax`` over the router logits, ``ArgTopK`` for the
  top-k indicator (a window rank / correlated count in SQL), and the gate
  renormalisation ``(mask ∘ probs) / Σ_row`` via ``RowReduce`` + ``recip``.
  The DeepSeek "pre" (softmax → top-k → renormalise) and DBRX/Mixtral
  "post" (top-k → softmax over the selected logits) conventions produce
  the *same* renormalised masked probabilities — exp-ratio identity — so
  one graph serves both of ``nn/moe.py``'s router modes.
* **dispatch / combine** — two formulations:
  ``moe_dispatch_graph`` / ``moe_combine_graph`` mirror the card's kernels
  (``kernels/moe_dispatch.py``: gather each slot's token row and scale by
  its gate — the join's select clause; ``kernels/ref.moe_combine``: group
  by destination token and sum) over an explicit slot→token index
  relation; ``moe_ffn_graph`` is the fully-in-DB layer, contracting the
  gating matrix against per-expert SwiGLU outputs (the paper's §5 array
  representation of the same relation — no data-dependent structure, so
  the plan caches across batches); ``moe_ffn_graph_batched`` replaces the
  3·E per-expert weight tables with ONE expert-indexed relation per
  parameter kind (expert folded into the row index, blocks selected by
  Gather index relations) — same layer, batched storage, and it lowers
  identically in the relational and array representations.

Capacity dropping (a load-balancing concern, not layer semantics) is not
modelled: differential tests pick configs where nothing overflows, where
``nn/moe.py``'s two impls and this SQL agree exactly.

Inputs may be numpy arrays or tensors on any device: they cross to the
database at :func:`repro_torch.device.to_host`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import expr as E
from ...device import resolve, to_host


@dataclasses.dataclass(frozen=True)
class MoESQLConfig:
    n_tokens: int
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class MoEGraph:
    cfg: MoESQLConfig
    x: E.Var
    out: E.Expr          # (T, d) combined expert output
    gates: E.Expr        # (T, E) renormalised gate matrix
    probs: E.Expr        # (T, E) router softmax
    weight_vars: tuple   # every weight Var, for value_and_grad_fn


def _silu(z: E.Expr) -> E.Expr:
    """silu(z) = z ∘ sig(z) — composed, no new MapFn needed."""
    return E.hadamard(z, E.sigmoid(z))


def router_graph(x: E.Expr, w_router: E.Expr, top_k: int
                 ) -> tuple[E.Expr, E.Expr, E.Expr]:
    """logits → (probs, topk mask, renormalised gates), all (T, E)."""
    e = w_router.shape[1]
    logits = E.matmul(x, w_router, name="router_logits")
    probs = E.softmax(logits, name="router_probs")
    mask = E.argtopk(probs, top_k, name="topk_mask")
    g = E.hadamard(mask, probs, name="gates_raw")
    norm = E.row_reduce(g, "sum", axis=1, name="gate_norm")
    gates = E.hadamard(
        g, E.matmul(E.recip(norm), E.const(1.0, (1, e))), name="gates")
    return probs, mask, gates


def moe_ffn_graph(cfg: MoESQLConfig) -> MoEGraph:
    """The full layer: route, per-expert SwiGLU, gate-weighted combine.

    Per-expert outputs are selected with the unit-basis index relations
    ``sel_e`` (Listing-5 one-hot columns, supplied by :func:`moe_env`):
    column e of the gate matrix is ``gates · sel_e`` — a join against an
    index relation, not a host-side slice."""
    t, d, e, f = cfg.n_tokens, cfg.d_model, cfg.n_experts, cfg.d_ff
    x = E.var("x", (t, d))
    w_router = E.var("w_router", (d, e))
    probs, _mask, gates = router_graph(x, w_router, cfg.top_k)
    weight_vars = [w_router]
    out = None
    for k in range(e):
        wi = E.var(f"wi_{k}", (d, f))
        wg = E.var(f"wg_{k}", (d, f))
        wo = E.var(f"wo_{k}", (f, d))
        weight_vars += [wi, wg, wo]
        y = E.matmul(E.hadamard(E.matmul(x, wi), _silu(E.matmul(x, wg))),
                     wo)
        col = E.matmul(gates, E.var(f"sel_{k}", (e, 1)))       # (T, 1)
        w = E.hadamard(E.matmul(col, E.const(1.0, (1, d))), y)
        out = w if out is None else E.add(out, w)
    return MoEGraph(cfg=cfg, x=x, out=out, gates=gates, probs=probs,
                    weight_vars=tuple(weight_vars))


def moe_ffn_graph_batched(cfg: MoESQLConfig) -> MoEGraph:
    """The full layer over ONE expert-indexed weight relation per parameter
    kind (the batched per-expert contraction): ``wi_all`` /
    ``wg_all`` are the (E·d, f) row-stack of every expert's matrix,
    ``wo_all`` the (E·f, d) stack — the ``expert`` column of the paper-style
    relation folded into the row index (expert = (i-1) // d).  Expert k's
    block is selected with the stored index relation ``rows_d_k`` /
    ``rows_f_k`` via ``Gather`` — a join, not a host-side slice — so
    Algorithm 1 routes the per-expert gradients back into the stacked
    relation through the adjoint ``Scatter``.  Works identically in the
    relational and the array representation."""
    t, d, e, f = cfg.n_tokens, cfg.d_model, cfg.n_experts, cfg.d_ff
    x = E.var("x", (t, d))
    w_router = E.var("w_router", (d, e))
    probs, _mask, gates = router_graph(x, w_router, cfg.top_k)
    wi_all = E.var("wi_all", (e * d, f))
    wg_all = E.var("wg_all", (e * d, f))
    wo_all = E.var("wo_all", (e * f, d))
    weight_vars = [w_router, wi_all, wg_all, wo_all]
    out = None
    for k in range(e):
        rows_d = E.var(f"rows_d_{k}", (d, 1))
        rows_f = E.var(f"rows_f_{k}", (f, 1))
        wi = E.gather(wi_all, rows_d, name=f"wi_b{k}")
        wg = E.gather(wg_all, rows_d, name=f"wg_b{k}")
        wo = E.gather(wo_all, rows_f, name=f"wo_b{k}")
        y = E.matmul(E.hadamard(E.matmul(x, wi), _silu(E.matmul(x, wg))),
                     wo)
        col = E.matmul(gates, E.var(f"sel_{k}", (e, 1)))       # (T, 1)
        w = E.hadamard(E.matmul(col, E.const(1.0, (1, d))), y)
        out = w if out is None else E.add(out, w)
    return MoEGraph(cfg=cfg, x=x, out=out, gates=gates, probs=probs,
                    weight_vars=tuple(weight_vars))


def moe_dispatch_graph(n_tokens: int, d_model: int, n_slots: int
                       ) -> tuple[E.Expr, E.Var, E.Var, E.Var]:
    """``kernels/moe_dispatch`` as IR: out[s, :] = gate[s] · x[tok[s], :].

    ``slot_token`` is the (S, 1) index relation of 0-based token rows (the
    expert-sorted ``sort_idx``), ``slot_gate`` the (S, 1) gate values.
    Returns (out, x, slot_token, slot_gate)."""
    x = E.var("x", (n_tokens, d_model))
    tok = E.var("slot_token", (n_slots, 1))
    gate = E.var("slot_gate", (n_slots, 1))
    out = E.hadamard(E.gather(x, tok),
                     E.matmul(gate, E.const(1.0, (1, d_model))),
                     name="dispatch")
    return out, x, tok, gate


def moe_combine_graph(n_slots: int, d_model: int, n_tokens: int
                      ) -> tuple[E.Expr, E.Var, E.Var]:
    """``kernels/ref.moe_combine`` as IR: group the slot relation by
    destination token, sum — one Scatter node.  Returns (out, y, tok)."""
    y = E.var("expert_out", (n_slots, d_model))
    tok = E.var("slot_token", (n_slots, 1))
    out = E.scatter(y, tok, n_tokens, name="combine")
    return out, y, tok


# ---------------------------------------------------------------------------
# parameters / env
# ---------------------------------------------------------------------------

def init_moe_params(cfg: MoESQLConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Small random weights in the ``nn/moe.py`` layout: stacked
    (E, d, f) expert tensors plus the (d, E) router."""
    rng = np.random.RandomState(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    return {"router": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
            "wo": w(e, f, d)}


def moe_env(cfg: MoESQLConfig, params: dict, x) -> dict:
    """Leaf tables for :func:`moe_ffn_graph`: data, weights and the E
    unit-basis selector relations."""
    e = cfg.n_experts
    wi, wg, wo = (to_host(params[k], dtype=None) for k in ("wi", "wg", "wo"))
    env = {"x": to_host(x, dtype=None),
           "w_router": to_host(params["router"], dtype=None)}
    eye = np.eye(e, dtype=np.float64)
    for k in range(e):
        env[f"wi_{k}"] = wi[k]
        env[f"wg_{k}"] = wg[k]
        env[f"wo_{k}"] = wo[k]
        env[f"sel_{k}"] = eye[:, k:k + 1]
    return env


def moe_env_batched(cfg: MoESQLConfig, params: dict, x) -> dict:
    """Leaf tables for :func:`moe_ffn_graph_batched`: the stacked
    expert-indexed weight relations, the E unit-basis selectors and the E
    block index relations (values = 0-based rows of expert k's block)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    env = {"x": to_host(x, dtype=None),
           "w_router": to_host(params["router"], dtype=None),
           "wi_all": to_host(params["wi"], dtype=None).reshape(e * d, f),
           "wg_all": to_host(params["wg"], dtype=None).reshape(e * d, f),
           "wo_all": to_host(params["wo"], dtype=None).reshape(e * f, d)}
    eye = np.eye(e, dtype=np.float64)
    for k in range(e):
        env[f"sel_{k}"] = eye[:, k:k + 1]
        env[f"rows_d_{k}"] = np.arange(k * d, (k + 1) * d,
                                       dtype=np.float64).reshape(-1, 1)
        env[f"rows_f_{k}"] = np.arange(k * f, (k + 1) * f,
                                       dtype=np.float64).reshape(-1, 1)
    return env


def moe_ffn_ref(cfg: MoESQLConfig, params: dict, x, *,
                dtype=torch.float64, device="cpu") -> np.ndarray:
    """Torch oracle with the exact graph semantics (softmax → top-k mask →
    renormalise → gate-weighted SwiGLU sum, no capacity), computed in
    ``dtype`` on ``device`` (float64 on the host by default) and returned
    as a float64 numpy array.  The differential tests additionally pin it
    against ``nn/moe.py`` + ``kernels/ref.py``."""
    from ...core import dense

    dev = resolve(device)

    def t(a):
        return torch.as_tensor(to_host(a), dtype=dtype, device=dev)

    x = t(x)
    logits = x @ t(params["router"])
    probs = torch.exp(logits - logits.amax(1, keepdim=True))
    probs = probs / probs.sum(1, keepdim=True)
    mask = dense.topk_mask(probs, cfg.top_k)
    g = mask * probs
    gates = g / g.sum(1, keepdim=True)
    h = torch.einsum("td,edf->tef", x, t(params["wi"]))
    gt = torch.einsum("td,edf->tef", x, t(params["wg"]))
    ys = torch.einsum("tef,efd->ted", h * (gt * (1 / (1 + torch.exp(-gt)))),
                      t(params["wo"]))
    return to_host(torch.einsum("te,ted->td", gates, ys))


def run_moe_in_db(cfg: MoESQLConfig, params: dict, x, *,
                  backend: str = "sqlite", engine=None,
                  batched: bool = False) -> np.ndarray:
    """Evaluate the full MoE layer inside the database; returns (T, d).
    ``batched=True`` uses the expert-indexed stacked weight relations
    (:func:`moe_ffn_graph_batched`) instead of E per-expert tables."""
    from ...obs import tracer_of
    from ..sql_engine import SQLEngine

    graph = moe_ffn_graph_batched(cfg) if batched else moe_ffn_graph(cfg)
    env = (moe_env_batched if batched else moe_env)(cfg, params, x)
    eng = engine if engine is not None else SQLEngine(backend=backend)
    try:
        with tracer_of(eng, eng.adapter).span(
                "zoo.moe_layer", n_experts=cfg.n_experts, top_k=cfg.top_k,
                batched=batched):
            out, = eng.evaluate([graph.out], env)
            return out
    finally:
        if engine is None:
            eng.close()
