"""Train and infer the paper's MLP *inside a database* (``repro_torch.db``).

The closed loop the paper argues for: the expression DAG is transpiled to
SQL, and a real engine (stdlib sqlite3 here; duckdb when installed) runs

1. the recursive-CTE training query — every gradient-descent iteration
   happens inside the database (Listing 7/10),
2. forward inference with the ``highestposition`` argmax as a window
   function (Listing 8),

then the result is differentially checked against ``Engine("dense")`` on
the card (its ``fused_sigmoid_matmul`` kernel).

    PYTHONPATH=src python -m repro_torch.examples.train_in_db
    PYTHONPATH=src python -m repro_torch.examples.train_in_db --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import Engine, nn2sql
from ..db.dialect import HAVE_DUCKDB
from ..db.plan_cache import default_cache
from ..db.train import (infer_in_db, loss_trajectory_in_db, predict_in_db,
                        train_in_db)
from ..device import resolve, to_host

N_ITERS = 30
# lr kept moderate: the database computes in float64, the dense engine in
# float32 — at aggressive learning rates gradient descent amplifies that
# representation gap chaotically (the backends are each self-consistent)
spec = nn2sql.MLPSpec(n_rows=60, n_features=4, n_hidden=10, n_classes=3,
                      lr=0.1)


def iris_like(spec, seed=0):
    """Synthetic Iris-shaped data: 3 Gaussian blobs over 4 features."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(spec.n_classes, spec.n_features)
    labels = rng.randint(0, spec.n_classes, spec.n_rows)
    x = centers[labels] + 0.08 * rng.randn(spec.n_rows, spec.n_features)
    y = np.eye(spec.n_classes, dtype=np.float32)[labels]
    return x.astype(np.float32), y, labels


def run(graph, weights, x, y, labels, n_iters: int, backend: str,
        device) -> dict:
    """Train and infer in the database from ``weights``, then train the
    same ``n_iters`` iterations on ``Engine("dense")`` on ``device`` and
    compare: the database's weights, probabilities and loss trajectory,
    the engine's weights and probabilities, and their largest
    differences."""
    # -- 1. train: one recursive-CTE query, all iterations in-DB -------------
    res = train_in_db(graph, weights, x, y, n_iters, backend=backend)
    traj = loss_trajectory_in_db(graph, res.history, x, y, backend=backend)

    # -- 2. infer: forward pass + highestposition in-DB -----------------------
    pred = predict_in_db(graph, res.weights, x, backend=backend)

    # -- 3. differential check vs the dense engine on the device -------------
    eng = Engine("dense", device=device)
    on_dev = lambda a: torch.as_tensor(a, device=eng.device)
    final, _ = nn2sql.train(graph, {k: on_dev(v) for k, v in weights.items()},
                            on_dev(x), on_dev(y), n_iters, eng)
    probs_db = infer_in_db(graph, res.weights, x, backend=backend)
    probs_dense = nn2sql.infer(graph, eng)(final, on_dev(x))
    return dict(
        result=res, trajectory=traj, accuracy_db=float(np.mean(pred == labels)),
        weights_dense=final, probs_db=probs_db, probs_dense=probs_dense,
        max_diff_weights=max(float(np.abs(to_host(final[k])
                                          - res.weights[k]).max())
                             for k in final),
        max_diff_probs=float(np.abs(probs_db - to_host(probs_dense)).max()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    graph = nn2sql.build_graph(spec)
    weights = {k: v.numpy()
               for k, v in nn2sql.init_weights(spec, device="cpu").items()}
    x, y, labels = iris_like(spec)
    backend = "duckdb" if HAVE_DUCKDB else "sqlite"
    print(f"== in-database backend: {backend} ==")

    out = run(graph, weights, x, y, labels, N_ITERS, backend, dev)
    res, traj = out["result"], out["trajectory"]
    # the query that actually ran (array variant on sqlite, Listing 7 on
    # duckdb — DBTrainResult carries it either way)
    print(f"\ntraining query ({len(res.sql)} chars), head:")
    print("\n".join(res.sql.splitlines()[:6]), "\n  ...")
    print(f"\nin-DB loss trajectory ({res.strategy}): "
          f"{traj[0]:.4f} -> {traj[-1]:.4f} over {res.n_iters} iters")
    print(f"in-DB accuracy (window-function argmax): "
          f"{out['accuracy_db']:.3f}")
    print(f"max |w_db - w_dense| after {N_ITERS} iters: "
          f"{out['max_diff_weights']:.2e}")
    print(f"max |m(x)_db - m(x)_dense|: {out['max_diff_probs']:.2e}")

    # -- 4. the rendered-SQL plan cache ---------------------------------------
    # training/inference SQL is rendered once per topology × dialect and
    # persisted (~/.cache/repro_torch/plan_cache.db unless
    # REPRO_PLAN_CACHE=off); re-running this example serves every query
    # text from the cache
    st = default_cache().stats
    print(f"\nplan cache: {st['hits']} hits / {st['misses']} misses this "
          f"run, {st['entries']} stored plans ({st['path'] or 'memory'})")
    return dict(backend=backend, rows=spec.n_rows, n_iters=N_ITERS,
                plan_cache=st, **out)


if __name__ == "__main__":
    main()
