"""The paper's MNIST image-classification benchmark, end to end (§6.3).

Trains the one-hidden-layer network on MNIST-shaped data at a chosen batch
size on both representations, then measures inference throughput — the
workload of the paper's Figures 9 and 10 — and reports accuracy (the paper
evaluates runtime/memory; accuracy here just proves learning happens).

    PYTHONPATH=src python -m repro_torch.examples.mnist_e2e --batch 1000 --hidden 20
    PYTHONPATH=src python -m repro_torch.examples.mnist_e2e --device cpu

On the card the labels go through ``onehot_embed``, the dense engine
through ``fused_sigmoid_matmul`` and the relational one through
``relational_matmul``.
"""
from __future__ import annotations

import argparse

from ..core import Engine, nn2sql
from ..data import make_mnist_like, one_hot_labels
from ..device import resolve
from . import timed

KINDS = ("dense", "relational")


def train_and_infer(graph, w0, x, y, y_oh, epochs: int, device) -> dict:
    """Each engine trains ``epochs`` iterations from ``w0``, then infers
    once warm and once timed: its weights, probabilities, accuracy,
    seconds and tuples/s."""
    runs = {}
    n = x.shape[0]
    for kind in KINDS:
        eng = Engine(kind, device=device)
        (wf, _), t_train = timed(
            lambda: nn2sql.train(graph, w0, x, y_oh, epochs, eng), eng.device)
        infer = nn2sql.infer(graph, eng)
        infer(wf, x)                                   # warm
        probs, t_inf = timed(lambda: infer(wf, x), eng.device)
        runs[kind] = dict(
            weights=wf, probs=probs, train_s=t_train, infer_s=t_inf,
            train_tuples_per_s=n * epochs / t_train,
            infer_tuples_per_s=n / max(t_inf, 1e-9),
            accuracy=float(nn2sql.accuracy(probs, y)))
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--hidden", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    x, y = make_mnist_like(args.batch, device=dev)
    y_oh = one_hot_labels(y, 10, device=dev)
    spec = nn2sql.MLPSpec(args.batch, 784, args.hidden, 10, lr=0.1)
    g = nn2sql.build_graph(spec)
    w0 = nn2sql.init_weights(spec, device=dev)

    runs = train_and_infer(g, w0, x, y, y_oh, args.epochs, dev)
    for kind, r in runs.items():
        print(f"[{kind:10s}] train {args.epochs} iters: {r['train_s']:6.2f}s "
              f"({r['train_tuples_per_s']:8.0f} tuples/s) | "
              f"inference: {r['infer_tuples_per_s']:9.0f} tuples/s | "
              f"acc {r['accuracy']:.3f}")
    return dict(batch=args.batch, hidden=args.hidden, epochs=args.epochs,
                runs=runs)


if __name__ == "__main__":
    main()
