"""State-space models transpiled to SQL (the §8 outlook's recurrent tier;
PyTorch port of ``repro.db.zoo.ssm_to_sql``).

Two SSM families over the zoo IR, both differentially tested against
``nn/ssm.py`` (:func:`repro_torch.nn.ssm.ssd_naive` is the ground-truth
oracle):

* **SSD / Mamba-2** — the scalar-decay matrix-state recurrence

      h_t = exp(a_t) · h_{t-1} + B_t x_tᵀ;     y_t = C_t · h_t

  Each (n, p) state cell evolves independently (scalar decay, rank-1
  additive update), so flattening (n, p) → column n·P+p turns the whole
  (N×P)-state scan into ONE elementwise affine ``Recurrence`` over an
  (S, N·P) relation — a single recursive CTE, exactly the RWKV-6
  machinery with the decay broadcast from a scalar instead of a vector.
  The flattening is relational: Kronecker index relations
  (:func:`ssd_kron_relations`) broadcast B over p and x over n via plain
  matmul joins; the output contraction Σ_n is the matmul against
  ``kron_pᵀ``.  **Chunked** execution (the Mamba-2 block decomposition's
  inter-chunk recurrence, arXiv:2405.21060) runs the sequence in
  fixed-size chunks — one query per chunk, the carried state folded into
  the next chunk's first step (b₁' = a₁ ∘ h₀ + b₁).

* **LRU** (Linear Recurrent Unit, and the S5-style dense-block variant) —
  the matrix-valued recurrence

      h_t = h_{t-1} · A + u_t · B;             y_t = h_t · C

  ``diagonal=True`` is the LRU/S5 fast path: diagonal A IS the
  elementwise ``Recurrence``.  ``diagonal=False`` carries a dense (D, D)
  block through ``MatRecurrence`` — the per-step blocks stacked into one
  (S·D, D) relation, lowered as a recursive CTE carrying the whole state
  row in one tuple (D columns relational, one array value in the array
  dialect).  Algorithm 1 differentiates both: the adjoint scan runs with
  transposed coefficients and the ∂A outer products stack via
  ``StepOuter``.

Inputs may be numpy arrays or tensors on any device: they cross to the
database at :func:`repro_torch.device.to_host`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...core import expr as E
from ...device import to_host
from ...obs import tracer_of


# ---------------------------------------------------------------------------
# index relations
# ---------------------------------------------------------------------------

def ssd_kron_relations(n: int, p: int) -> dict[str, np.ndarray]:
    """The 0/1 broadcast relations of the (n, p) → n·P+p flattening:

    ``kron_n`` (N, N·P): [n, n·P+p] = 1 — left factor, repeats over p;
    ``kron_p`` (P, N·P): [p, n·P+p] = 1 — right factor, tiles over n.

    ``B @ kron_n`` spreads a length-N row over the N·P state columns by
    the *n* index, ``x @ kron_p`` by the *p* index; ``h @ kron_pᵀ`` sums
    a state row over *n* for each p — the C_t·h_t output contraction is
    ``(C@kron_n ∘ h) @ kron_pᵀ``."""
    kn = np.zeros((n, n * p))
    kp = np.zeros((p, n * p))
    for a in range(n):
        kn[a, a * p:(a + 1) * p] = 1.0
    for b in range(p):
        kp[b, b::p] = 1.0
    return {"kron_n": kn, "kron_p": kp}


def _first_row_indicator(rows: int) -> np.ndarray:
    e1 = np.zeros((rows, 1))
    e1[0, 0] = 1.0
    return e1


# ---------------------------------------------------------------------------
# SSD / Mamba-2: scalar-decay matrix state as ONE elementwise scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSDGraph:
    seq: int
    n: int                   # state size N
    p: int                   # head dim P
    y: E.Expr                # (S, P) per-token output
    h: E.Expr                # (S, N·P) post-update state trajectory
    leaves: tuple            # the xt/bt/ct/da/h0 Vars


def ssd_scan_graph(seq: int, n: int, p: int) -> SSDGraph:
    """One head's SSD recurrence as a single-scan DAG.

    Leaf relations: ``xt`` (S, P), ``bt``/``ct`` (S, N), ``da`` (S, 1)
    the *exponentiated* decay exp(a_t), ``h0`` (1, N·P) initial state
    (row-major flattened), plus the static index relations of
    :func:`ssd_static_env`."""
    np_ = n * p
    xt = E.var("xt", (seq, p))
    bt = E.var("bt", (seq, n))
    ct = E.var("ct", (seq, n))
    da = E.var("da", (seq, 1))
    h0 = E.var("h0", (1, np_))
    kn = E.var("kron_n", (n, np_))
    kp = E.var("kron_p", (p, np_))
    e1 = E.var("e_first", (seq, 1))

    decay = E.matmul(da, E.const(1.0, (1, np_)), name="decay_flat")
    kv = E.hadamard(E.matmul(bt, kn), E.matmul(xt, kp), name="bx_flat")
    h0_row1 = E.matmul(e1, h0)           # (S, N·P), h0 in row 1, else 0
    b_eff = E.add(kv, E.hadamard(decay, h0_row1))  # fold h0 into step 1
    h = E.recurrence(decay, b_eff, name="ssd_scan")  # h_t, post-update
    y = E.matmul(E.hadamard(E.matmul(ct, kn), h), E.transpose(kp),
                 name="ssd_y")
    return SSDGraph(seq=seq, n=n, p=p, y=y, h=h,
                    leaves=(xt, bt, ct, da, h0))


def ssd_static_env(seq: int, n: int, p: int) -> dict[str, np.ndarray]:
    env = ssd_kron_relations(n, p)
    env["e_first"] = _first_row_indicator(seq)
    return env


def ssd_env(x, a, b, c, h0=None) -> dict[str, np.ndarray]:
    """Leaf tables from the ``nn/ssm.ssd_naive`` single-head convention:
    x (S, P), a (S,) LOG decay (exponentiated host-side — the IR has no
    exp map), b/c (S, N), h0 (N, P) or None."""
    x, b, c = (to_host(t, dtype=None) for t in (x, b, c))
    seq, p = x.shape
    n = b.shape[1]
    env = ssd_static_env(seq, n, p)
    env.update(xt=x, bt=b, ct=c, da=np.exp(to_host(a)).reshape(seq, 1),
               h0=(np.zeros((1, n * p)) if h0 is None
                   else to_host(h0, dtype=None).reshape(1, n * p)))
    return env


def ssd_ref(x, a, b, c, h0=None) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of ``nn/ssm.ssd_naive`` for one (batch, head): returns
    (y (S, P), h_fin (N, P))."""
    x = to_host(x)
    a, b, c = (to_host(t, dtype=None) for t in (a, b, c))
    seq, p = x.shape
    n = b.shape[1]
    h = np.zeros((n, p)) if h0 is None else to_host(h0)
    ys = np.zeros((seq, p))
    for t in range(seq):
        h = np.exp(float(a[t])) * h + np.outer(b[t], x[t])
        ys[t] = c[t] @ h
    return ys, h


def run_ssd_in_db(x, a, b, c, h0=None, *, chunk: int | None = None,
                  backend: str = "sqlite", engine=None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The SSD scan inside the database: returns (y (S, P), h_fin (N, P)).

    ``chunk`` runs the Mamba-2-style chunked execution: the sequence is
    cut into fixed-size chunks, each chunk ONE query (its own recursive
    CTE), and the chunk-final state row is carried into the next chunk's
    ``h0`` leaf — the inter-chunk recurrence of the block decomposition,
    at query granularity.  ``engine`` may be any ``SQLEngine`` (pass
    ``SQLEngine(dialect="array")`` for the array representation)."""
    from ..sql_engine import SQLEngine

    x = to_host(x, dtype=None)
    a = to_host(a)
    b, c = to_host(b, dtype=None), to_host(c, dtype=None)
    seq, p = x.shape
    n = b.shape[1]
    eng = engine if engine is not None else SQLEngine(backend=backend)
    tr = tracer_of(eng, eng.adapter)
    try:
        chunk = seq if not chunk else min(chunk, seq)
        carry = None if h0 is None else to_host(h0, dtype=None)
        ys = []
        with tr.span("zoo.ssd_scan", seq=seq, chunk=chunk, n=n, p=p):
            for s in range(0, seq, chunk):
                e = min(seq, s + chunk)
                graph = ssd_scan_graph(e - s, n, p)
                env = ssd_env(x[s:e], a[s:e], b[s:e], c[s:e], carry)
                with tr.span("zoo.ssd_chunk", start=s, stop=e):
                    y, h = eng.evaluate([graph.y, graph.h], env)
                ys.append(y)
                carry = h[-1].reshape(n, p)
        return np.concatenate(ys, axis=0), carry
    finally:
        if engine is None:
            eng.close()


# ---------------------------------------------------------------------------
# LRU / S5: matrix-valued (dense-block or diagonal) linear RNN layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LRUGraph:
    seq: int
    d_in: int
    d_state: int
    d_out: int
    diagonal: bool
    y: E.Expr                # (S, d_out)
    h: E.Expr                # (S, d_state) state trajectory
    leaves: tuple            # u, a (stack or diag row), wb, wc


def lru_layer_graph(seq: int, d_in: int, d_state: int, d_out: int,
                    diagonal: bool = False) -> LRUGraph:
    """An LRU-style linear RNN layer: h_t = h_{t-1}·A + u_t·B, y = h·C.

    ``diagonal=True`` stores A as one (1, D) row ``lam`` and scans with
    the elementwise ``Recurrence`` (the LRU/S5 diagonal fast path);
    ``diagonal=False`` stores the per-step blocks as the (S·D, D)
    relation ``a_stack`` (time-invariant A = the same block tiled S
    times — data-dependent A_t drops in unchanged) and scans with
    ``MatRecurrence``."""
    u = E.var("u", (seq, d_in))
    wb = E.var("wb", (d_in, d_state))
    wc = E.var("wc", (d_state, d_out))
    b = E.matmul(u, wb, name="lru_b")
    if diagonal:
        lam = E.var("lam", (1, d_state))
        decay = E.matmul(E.const(1.0, (seq, 1)), lam)
        h = E.recurrence(decay, b, name="lru_scan")
        a_leaf = lam
    else:
        a_stack = E.var("a_stack", (seq * d_state, d_state))
        h = E.mat_recurrence(a_stack, b, name="lru_scan")
        a_leaf = a_stack
    y = E.matmul(h, wc, name="lru_y")
    return LRUGraph(seq=seq, d_in=d_in, d_state=d_state, d_out=d_out,
                    diagonal=diagonal, y=y, h=h,
                    leaves=(u, a_leaf, wb, wc))


def lru_env(graph: LRUGraph, u, a, wb, wc) -> dict[str, np.ndarray]:
    """Leaf tables: ``a`` is the (D, D) transition matrix (dense graph:
    tiled into the stack) or the (D,) diagonal (diagonal graph)."""
    a = to_host(a)
    env = {"u": to_host(u, dtype=None), "wb": to_host(wb, dtype=None),
           "wc": to_host(wc, dtype=None)}
    if graph.diagonal:
        env["lam"] = a.reshape(1, graph.d_state)
    else:
        env["a_stack"] = np.tile(a, (graph.seq, 1))
    return env


def lru_ref(u, a, wb, wc, diagonal: bool = False
            ) -> tuple[np.ndarray, np.ndarray]:
    """NumPy oracle of :func:`lru_layer_graph`: (y, h trajectory)."""
    u, a = to_host(u), to_host(a)
    wb, wc = to_host(wb, dtype=None), to_host(wc, dtype=None)
    b = u @ wb
    h = np.zeros(b.shape[1])
    hs = np.zeros_like(b)
    for t in range(u.shape[0]):
        h = (h * a if diagonal else h @ a) + b[t]
        hs[t] = h
    return hs @ wc, hs


def run_lru_in_db(u, a, wb, wc, *, diagonal: bool = False,
                  backend: str = "sqlite", engine=None) -> np.ndarray:
    """Forward LRU layer in-database: returns y (S, d_out)."""
    from ..sql_engine import SQLEngine

    u, a, wb, wc = (to_host(t, dtype=None) for t in (u, a, wb, wc))
    graph = lru_layer_graph(u.shape[0], u.shape[1], wb.shape[1],
                            wc.shape[1], diagonal=diagonal)
    eng = engine if engine is not None else SQLEngine(backend=backend)
    try:
        with tracer_of(eng, eng.adapter).span(
                "zoo.lru_forward", seq=graph.seq, d_state=graph.d_state,
                diagonal=diagonal):
            y, = eng.evaluate([graph.y], lru_env(graph, u, a, wb, wc))
            return y
    finally:
        if engine is None:
            eng.close()


def lru_grads_in_db(u, a, wb, wc, *, diagonal: bool = False,
                    backend: str = "sqlite", engine=None
                    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Forward + Algorithm-1 backward of the squared-output loss
    Σ y², entirely in-database: returns (loss value matrix, {leaf:
    gradient}).  The gradient of the transition comes back in the stored
    layout — the (S·D, D) stack (dense; sum the per-step blocks for the
    time-invariant ∂A) or the (1, D) diagonal row."""
    from ..sql_engine import SQLEngine

    u, a, wb, wc = (to_host(t, dtype=None) for t in (u, a, wb, wc))
    graph = lru_layer_graph(u.shape[0], u.shape[1], wb.shape[1],
                            wc.shape[1], diagonal=diagonal)
    loss = E.square(graph.y, name="lru_loss")
    wrt = list(graph.leaves)
    eng = engine if engine is not None else SQLEngine(backend=backend)
    try:
        with tracer_of(eng, eng.adapter).span(
                "zoo.lru_grads", seq=graph.seq, d_state=graph.d_state,
                diagonal=diagonal):
            vg = eng.value_and_grad_fn(loss, wrt)
            return vg(lru_env(graph, u, a, wb, wc))
    finally:
        if engine is None:
            eng.close()
