"""RWKV recurrences transpiled to SQL (recursive-CTE scans; PyTorch port of
``repro.db.zoo.rwkv_to_sql``).

Two of the RWKV-6 building blocks (``kernels/rwkv6_scan.py``,
``nn/ssm.py``) over the zoo IR:

* **time mix** — the matrix-state recurrence

      o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

  Each state cell evolves independently:  S_t[a,b] = w_t[a]·S_{t-1}[a,b]
  + k_t[a]·v_t[b], so flattening (a, b) → column a·N+b turns the whole
  (N×N)-state scan into ONE elementwise affine ``Recurrence`` over an
  (S, N²) relation — a single recursive CTE, every column walking its own
  chain.  The flattening itself is relational: Kronecker *index
  relations* (0/1 matrices ``kron_a``/``kron_b``, :func:`kron_index_relations`)
  broadcast k over b and v over a via plain matmul joins, and the output
  contraction Σ_a is the matmul against ``kron_bᵀ``.

* **channel mix** — token shift (``RowShift``) + mix/σ/relu² FFN, no
  recursion beyond the shift.

Both are differentially tested against ``kernels/ref.py`` / the numpy
references below (≤1e-4).  Inputs may be numpy arrays or tensors on any
device: they cross to the database at :func:`repro_torch.device.to_host`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...core import expr as E
from ...device import to_host


# ---------------------------------------------------------------------------
# index relations
# ---------------------------------------------------------------------------

def kron_index_relations(n: int) -> dict[str, np.ndarray]:
    """The 0/1 broadcast relations of the (a, b) → a·N+b flattening:

    ``kron_a``  (N, N²): [a, a·N+b] = 1 — left factor, repeats over b;
    ``kron_b``  (N, N²): [b, a·N+b] = 1 — right factor, tiles over a.

    ``x @ kron_a`` spreads a length-N row over the N² state columns by the
    *a* index, ``x @ kron_b`` by the *b* index; ``y @ kron_bᵀ`` sums a
    state row over *a* for each b.  These are stored index relations — the
    sparse join partners of the paper's one-hot construction."""
    ka = np.zeros((n, n * n))
    kb = np.zeros((n, n * n))
    for a in range(n):
        ka[a, a * n:(a + 1) * n] = 1.0
    for b in range(n):
        kb[b, b::n] = 1.0
    return {"kron_a": ka, "kron_b": kb}


def _first_row_indicator(rows: int) -> np.ndarray:
    e1 = np.zeros((rows, 1))
    e1[0, 0] = 1.0
    return e1


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKVGraph:
    seq: int
    n: int
    o: E.Expr            # (S, N) per-token output
    state: E.Expr        # (S, N²) post-update state trajectory
    leaves: tuple        # the r/k/v/w/u/s0 Vars


def rwkv6_time_mix_graph(seq: int, n: int) -> RWKVGraph:
    """One head's RWKV-6 time-mix recurrence as a single-scan DAG.

    Leaf relations: ``r``/``k``/``v``/``w`` (S, N), ``u`` (1, N),
    ``s0`` (1, N²) initial state (row-major flattened), plus the static
    index relations of :func:`rwkv6_static_env`."""
    nn = n * n
    r = E.var("r", (seq, n))
    k = E.var("k", (seq, n))
    v = E.var("v", (seq, n))
    w = E.var("w", (seq, n))
    u = E.var("u", (1, n))
    s0 = E.var("s0", (1, nn))
    ka = E.var("kron_a", (n, nn))
    kb = E.var("kron_b", (n, nn))
    e1 = E.var("e_first", (seq, 1))

    decay = E.matmul(w, ka, name="decay_flat")             # w[t,a] over b
    kv = E.hadamard(E.matmul(k, ka), E.matmul(v, kb), name="kv_flat")
    s0_row1 = E.matmul(e1, s0)            # (S, N²), s0 in row 1, else 0
    b_eff = E.add(kv, E.hadamard(decay, s0_row1))   # fold s0 into step 1
    state = E.recurrence(decay, b_eff, name="state_scan")  # S_t, post-update
    s_prev = E.add(E.row_shift(state, 1), s0_row1, name="state_prev")

    r_flat = E.matmul(r, ka)                               # r[t,a] over b
    term1 = E.matmul(E.hadamard(r_flat, s_prev), E.transpose(kb))
    u_rows = E.matmul(E.const(1.0, (seq, 1)), u)           # (S, N)
    bonus = E.row_reduce(E.hadamard(E.hadamard(r, k), u_rows), "sum",
                         axis=1, name="bonus")             # Σ_a r·u·k
    term2 = E.hadamard(E.matmul(bonus, E.const(1.0, (1, n))), v)
    o = E.add(term1, term2, name="o")
    return RWKVGraph(seq=seq, n=n, o=o, state=state,
                     leaves=(r, k, v, w, u, s0))


def rwkv6_static_env(seq: int, n: int) -> dict[str, np.ndarray]:
    env = kron_index_relations(n)
    env["e_first"] = _first_row_indicator(seq)
    return env


def rwkv6_env(r, k, v, w, u, s0) -> dict[str, np.ndarray]:
    """Leaf tables from (S, N) inputs, (N,) u and (N, N) s0."""
    r, k, v, w, u, s0 = (to_host(a, dtype=None) for a in (r, k, v, w, u, s0))
    seq, n = r.shape
    env = rwkv6_static_env(seq, n)
    env.update(r=r, k=k, v=v, w=w, u=u.reshape(1, n),
               s0=s0.reshape(1, n * n))
    return env


def run_rwkv6_in_db(r, k, v, w, u, s0, *, backend: str = "sqlite",
                    engine=None) -> tuple[np.ndarray, np.ndarray]:
    """The time-mix recurrence inside the database: returns
    (o (S, N), s_fin (N, N)) like ``kernels/ref.rwkv6_scan`` per head."""
    from ...obs import tracer_of
    from ..sql_engine import SQLEngine

    env = rwkv6_env(r, k, v, w, u, s0)
    seq, n = env["r"].shape
    graph = rwkv6_time_mix_graph(seq, n)
    eng = engine if engine is not None else SQLEngine(backend=backend)
    try:
        with tracer_of(eng, eng.adapter).span("zoo.rwkv6_time_mix",
                                              seq=seq, n=n):
            o, states = eng.evaluate([graph.o, graph.state], env)
            return o, states[-1].reshape(n, n)
    finally:
        if engine is None:
            eng.close()


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChannelMixGraph:
    seq: int
    d: int
    d_ff: int
    out: E.Expr
    leaves: tuple


def rwkv_channel_mix_graph(seq: int, d: int, d_ff: int) -> ChannelMixGraph:
    """RWKV channel mix: token-shift mixing, k = relu(xk·Wk)², out =
    σ(xr·Wr) ∘ (k·Wv).  The token shift is ``RowShift`` — the shifted
    relation is the same table with its row index displaced by one."""
    x = E.var("x", (seq, d))
    mu_k = E.var("mu_k", (1, d))
    mu_r = E.var("mu_r", (1, d))
    wk = E.var("wk", (d, d_ff))
    wv = E.var("wv", (d_ff, d))
    wr = E.var("wr", (d, d))
    xx = E.row_shift(x, 1, name="token_shift")
    ones_col = E.const(1.0, (seq, 1))
    ones_mat = E.const(1.0, (seq, d))
    mk = E.matmul(ones_col, mu_k)
    mr = E.matmul(ones_col, mu_r)
    xk = E.add(E.hadamard(x, mk), E.hadamard(xx, E.sub(ones_mat, mk)))
    xr = E.add(E.hadamard(x, mr), E.hadamard(xx, E.sub(ones_mat, mr)))
    kk = E.square(E.relu(E.matmul(xk, wk)))
    out = E.hadamard(E.sigmoid(E.matmul(xr, wr)), E.matmul(kk, wv),
                     name="cmix_out")
    return ChannelMixGraph(seq=seq, d=d, d_ff=d_ff, out=out,
                           leaves=(x, mu_k, mu_r, wk, wv, wr))


def rwkv_channel_mix_ref(x, mu_k, mu_r, wk, wv, wr) -> np.ndarray:
    """NumPy oracle of :func:`rwkv_channel_mix_graph`."""
    x = to_host(x)
    mu_k, mu_r, wk, wv, wr = (to_host(a, dtype=None)
                              for a in (mu_k, mu_r, wk, wv, wr))
    xx = np.zeros_like(x)
    xx[1:] = x[:-1]
    xk = x * mu_k + xx * (1.0 - mu_k)
    xr = x * mu_r + xx * (1.0 - mu_r)
    kk = np.square(np.maximum(xk @ wk, 0.0))
    return (1.0 / (1.0 + np.exp(-(xr @ wr)))) * (kk @ wv)


def run_channel_mix_in_db(x, mu_k, mu_r, wk, wv, wr, *,
                          backend: str = "sqlite", engine=None) -> np.ndarray:
    from ...obs import tracer_of
    from ..sql_engine import SQLEngine

    x, mu_k, mu_r, wk, wv, wr = (to_host(a, dtype=None)
                                 for a in (x, mu_k, mu_r, wk, wv, wr))
    seq, d = x.shape
    graph = rwkv_channel_mix_graph(seq, d, wk.shape[1])
    env = {"x": x, "mu_k": mu_k.reshape(1, d), "mu_r": mu_r.reshape(1, d),
           "wk": wk, "wv": wv, "wr": wr}
    eng = engine if engine is not None else SQLEngine(backend=backend)
    try:
        with tracer_of(eng, eng.adapter).span("zoo.channel_mix",
                                              seq=seq, d=d):
            out, = eng.evaluate([graph.out], env)
            return out
    finally:
        if engine is None:
            eng.close()
