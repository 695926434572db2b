"""Quickstart: the paper end-to-end in 60 seconds.

Transforms Iris into the relational representation (§4.1), trains the
2-layer sigmoid network by gradient descent inside a recursive CTE (§4.2)
on BOTH execution engines, evaluates prediction accuracy (§4.3), and
prints the actual SQL-92 + SQL/Array queries the transpiler generates —
Listings 7 and 10 of the paper, derived automatically by Algorithm 1.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the card the dense engine runs ``fused_sigmoid_matmul`` and the
relational one ``relational_matmul``, at Iris's shapes (150 rows, 4
features, 3 classes).
"""
from __future__ import annotations

import argparse

from ..core import Engine, nn2sql, sqlgen
from ..core.relational import one_hot_dense
from ..data import make_iris
from ..device import resolve
from . import timed

ITERS = 300
HIDDEN = 20
KINDS = ("dense", "relational")


def train_both(graph, w0, x, y, y_oh, iters: int, device) -> dict:
    """``iters`` iterations from ``w0`` on each engine, then inference:
    each engine's final weights, probabilities, accuracy and training
    seconds."""
    runs = {}
    for kind in KINDS:
        eng = Engine(kind, device=device)
        (wf, _), seconds = timed(
            lambda: nn2sql.train(graph, w0, x, y_oh, iters, eng), eng.device)
        probs = nn2sql.infer(graph, eng)(wf, x)
        runs[kind] = dict(weights=wf, probs=probs, seconds=seconds,
                          accuracy=float(nn2sql.accuracy(probs, y)))
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    x, y = make_iris(device=dev)
    y_oh = one_hot_dense(y, 3).to_dense()        # Listing 5: outer join
    spec = nn2sql.MLPSpec(n_rows=150, n_features=4, n_hidden=HIDDEN,
                          n_classes=3, lr=0.05)
    graph = nn2sql.build_graph(spec)
    w0 = nn2sql.init_weights(spec, device=dev)

    runs = train_both(graph, w0, x, y, y_oh, ITERS, dev)
    for kind, run in runs.items():
        rep = "array data type (Section 5)" if kind == "dense" \
            else "relational / SQL-92 (Section 4)"
        print(f"[{rep}] {ITERS} iterations in {run['seconds']:.2f}s — "
              f"accuracy {run['accuracy']:.3f}")

    print("\n--- generated SQL-92 training query (Listing 7) "
          "[first 40 lines] ---")
    sql92 = sqlgen.training_query_sql92(graph, ITERS, spec.lr)
    print("\n".join(sql92.splitlines()[:40]))
    print("  ...")
    print("\n--- generated SQL+Arrays training query (Listing 10) "
          "[first 15 lines] ---")
    arrays = sqlgen.training_query_arrays(graph, ITERS, spec.lr)
    print("\n".join(arrays.splitlines()[:15]))
    print("  ...")
    return dict(iters=ITERS, runs=runs, sql92=sql92, arrays=arrays)


if __name__ == "__main__":
    main()
