"""The paper's neural network (Section 2.2) over the expression IR
(PyTorch port of ``repro.core.nn2sql``).

    m(x)      = sig(sig(x · w_xh) · w_ho)                       (Eq. 4)
    l(x, y)   = (m(x) − y_ones)^∘2                              (Eq. 5)

with the backward pass of Equations 6–11 generated by Algorithm 1
(``core.autodiff``), executable on any engine and printable as SQL
(``core.sqlgen``). Weight init follows
Listing 2: seed(1), U[-1, 1) — the same numpy stream as the JAX package,
so both start from bit-identical weights.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve
from ..obs import tracer as obs
from . import expr as E
from .engine import Engine, sgd_step_fn
from .recursive_cte import recursive_cte


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    n_rows: int          # batch of input tuples
    n_features: int      # m  (Iris: 4, MNIST: 784)
    n_hidden: int        # h  (paper: 20/50/200)
    n_classes: int       # l  (Iris: 3, MNIST: 10)
    lr: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLPGraph:
    spec: MLPSpec
    img: E.Var           # feature relation  (n_rows × n_features)
    one_hot: E.Var       # label relation    (n_rows × n_classes)
    w_xh: E.Var
    w_ho: E.Var
    a_xh: E.Expr         # sig(img · w_xh)
    a_ho: E.Expr         # sig(a_xh · w_ho) — the model output
    loss: E.Expr         # (a_ho − one_hot)^∘2


@functools.lru_cache(maxsize=64)
def build_graph(spec: MLPSpec) -> MLPGraph:
    """Memoised per spec (frozen, hashable): callers asking for the same
    topology share one DAG object, so engine-side memoisation and the
    rendered-SQL plan cache (``repro_torch.db.plan_cache``) hit by identity
    within a session — and by structural signature across sessions."""
    img = E.var("img", (spec.n_rows, spec.n_features))
    one_hot = E.var("one_hot", (spec.n_rows, spec.n_classes))
    w_xh = E.var("w_xh", (spec.n_features, spec.n_hidden))
    w_ho = E.var("w_ho", (spec.n_hidden, spec.n_classes))
    a_xh = E.sigmoid(E.matmul(img, w_xh, name="z_xh"), name="a_xh")
    a_ho = E.sigmoid(E.matmul(a_xh, w_ho, name="z_ho"), name="a_ho")
    loss = E.square(E.sub(a_ho, one_hot, name="diff"), name="loss")
    return MLPGraph(spec=spec, img=img, one_hot=one_hot, w_xh=w_xh,
                    w_ho=w_ho, a_xh=a_xh, a_ho=a_ho, loss=loss)


def init_weights(spec: MLPSpec, seed: int = 1, device="cuda"
                 ) -> dict[str, torch.Tensor]:
    """Listing 2 lines 10–12: np.random.seed(1); 2·random(shape) − 1."""
    dev = resolve(device)
    rng = np.random.RandomState(seed)
    w_xh = 2 * rng.random_sample((spec.n_features, spec.n_hidden)) - 1
    w_ho = 2 * rng.random_sample((spec.n_hidden, spec.n_classes)) - 1
    return {"w_xh": torch.as_tensor(w_xh, dtype=torch.float32, device=dev),
            "w_ho": torch.as_tensor(w_ho, dtype=torch.float32, device=dev)}


def train(graph: MLPGraph, weights, x: torch.Tensor, y_onehot: torch.Tensor,
          n_iters: int, engine: Engine, materialize_history: bool = False):
    """Gradient descent as a recursive CTE (Listing 7 / Listing 10).

    With ``Engine("sql")`` the recursion itself runs *inside* the database
    (one recursive-CTE query, :mod:`repro_torch.db.train`), and the result
    comes back as float32 tensors on ``engine.device``; the tensor engines
    run it by :func:`repro_torch.core.recursive_cte.recursive_cte`.
    """
    if engine.kind == "sql":
        from ..db.train import train_in_db  # lazy: core ↛ db cycle

        sql_eng = engine._sql
        res = train_in_db(graph, weights, x, y_onehot, n_iters,
                          adapter=sql_eng.adapter,
                          representation=("array"
                                          if sql_eng.representation == "array"
                                          else "auto"),
                          plan_cache_=(sql_eng.plans
                                       if sql_eng.plans is not None
                                       else False))

        def on_device(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                engine.device)

        final = {k: on_device(v) for k, v in res.weights.items()}
        if not materialize_history:
            return final, None
        return final, {k: on_device(np.stack([w[k] for w in res.history]))
                       for k in final}
    step = sgd_step_fn(graph.loss, [graph.w_xh, graph.w_ho],
                       graph.spec.lr, engine)
    data_env = {"img": x, "one_hot": y_onehot}
    rows = graph.spec.n_rows

    def cte_step(w, it):
        with obs.span("nn2sql.iteration", it=it, rows=rows) as sp:
            allocs = obs.device_allocs(x.device)
            new_w, _ = step(w, data_env)
            if allocs is not None:
                sp.set(cuda_mallocs=obs.device_allocs(x.device) - allocs)
        return new_w

    return recursive_cte(weights, cte_step, n_iters,
                         materialize_history=materialize_history)


def infer(graph: MLPGraph, engine: Engine):
    """Model-function evaluation (forward pass only), Listing 8/11."""
    fn = engine.eval_fn([graph.a_ho])

    def run(weights, x):
        probs, = fn({**weights, "img": x})
        return probs

    return run


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``highestposition(m(x)) = highestposition(one_hot)`` — the paper's
    rank-1 comparison (Listing 8/11), as a fraction of correct tuples.
    ``probs`` may be the SQL backend's numpy result."""
    probs = torch.as_tensor(probs)
    labels = torch.as_tensor(labels, device=probs.device)
    return (probs.argmax(dim=1) == labels).to(torch.float32).mean()


# ---------------------------------------------------------------------------
# NumPy reference (Listing 2) — the paper's baseline implementation
# ---------------------------------------------------------------------------

def numpy_train(x: np.ndarray, y_onehot: np.ndarray, n_hidden: int,
                n_iters: int, lr: float = 0.01, seed: int = 1):
    rng = np.random.RandomState(seed)
    w_xh = 2 * rng.random_sample((x.shape[1], n_hidden)) - 1
    w_ho = 2 * rng.random_sample((n_hidden, y_onehot.shape[1])) - 1
    for _ in range(n_iters):
        a_xh = 1.0 / (1.0 + np.exp(-x.dot(w_xh)))
        a_ho = 1.0 / (1.0 + np.exp(-a_xh.dot(w_ho)))
        l_ho = 2.0 * (a_ho - y_onehot)
        d_ho = l_ho * a_ho * (1.0 - a_ho)
        l_xh = d_ho.dot(w_ho.T)
        d_xh = l_xh * a_xh * (1.0 - a_xh)
        w_ho -= lr * a_xh.T.dot(d_ho)
        w_xh -= lr * x.T.dot(d_xh)
    return {"w_xh": w_xh, "w_ho": w_ho}


def manual_gradients(graph: MLPGraph):
    """The hand-derived backward graph of Equations 6–11 (used as a test
    oracle against Algorithm 1's output)."""
    a_xh, a_ho = graph.a_xh, graph.a_ho
    one = E.const(1.0, a_ho.shape)
    l_ho = E.scale(2.0, E.sub(a_ho, graph.one_hot))                    # Eq. 6
    d_ho = E.hadamard(l_ho, E.hadamard(a_ho, E.sub(one, a_ho)))        # Eq. 7
    l_xh = E.matmul(d_ho, E.transpose(graph.w_ho))                     # Eq. 8
    one_h = E.const(1.0, a_xh.shape)
    d_xh = E.hadamard(l_xh, E.hadamard(a_xh, E.sub(one_h, a_xh)))      # Eq. 9
    g_ho = E.matmul(E.transpose(a_xh), d_ho)                           # Eq. 10
    g_xh = E.matmul(E.transpose(graph.img), d_xh)                      # Eq. 11
    return {graph.w_xh: g_xh, graph.w_ho: g_ho}
