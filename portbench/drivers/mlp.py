"""The paper's MLP (Eq. 4/5) on the engines of ``repro_torch.core``:
full-batch gradient descent, Listing 10's recursive CTE through
``nn2sql.train`` called in chunks of iterations with the weights carried
forward, over a table of ``n_rows`` rows made from the seed.

Set-up makes the window's own call, ``passes_per_call`` = k iterations,
three times, and the weights before and after each call are kept.  The
reference (Listing 2 in float64) runs each call's k iterations again from
the weights that call started from, and each call's mean gradient,
(w_t - w_t+k) / (k lr) (plain gradient descent keeps no other state), is
compared leaf by leaf: every iteration of every call, not only the first,
is held to the reference.  The reference follows the program's own
weights from call to call, not its own trajectory from the start: over
3 k iterations the two trajectories part by what float32 rounding alone
sets off on some seeds (PERF.md §2), where a call's k iterations from one
start do not; the first call starts from the seed's weights, which both
sides make.  ``nn2sql.train`` returns no loss, so no loss is compared."""
from __future__ import annotations

import time

import torch

from .. import compare, counts, harness, inputs
from ..reference import mlp as ref

FIRST_CALLS = 3


def _inputs(c: dict, seed: int, device):
    gen = inputs.generator(seed, device)
    x, labels = inputs.mnist_like(c["n_rows"], c["n_features"],
                                  c["n_classes"], gen)
    w0 = inputs.listing2_weights(c["n_features"], c["n_hidden"],
                                 c["n_classes"], gen)
    return x, labels, w0


def _norms(w: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in w.items()}


def mean_grads(history: list, lr: float, k: int) -> list:
    """[{leaf: norm of (w_t - w_t+1) / (k lr)}] of the weights before and
    after each call of k iterations."""
    return [_norms({n: (a[n].double() - b[n].double()) / (k * lr) for n in a})
            for a, b in zip(history, history[1:])]


def reference_grads(x, labels, starts: list, lr: float, k: int,
                    precision: str = "float64") -> list:
    """The reference's mean gradient over k iterations from each weights
    of ``starts``, as ``mean_grads`` reads it."""
    out = []
    for w in starts:
        hist = ref.train(x, labels, w, lr, k, precision)
        out += mean_grads([hist[0], hist[-1]], lr, k)
    return out


def control_readings(c: dict, tr: dict, seed: int, device, below: str,
                     stated: str) -> dict:
    """The reference in ``below`` in the program's place: its own weights
    through the three calls, each call judged by the reference in
    ``stated`` from the weights that call started from."""
    x, labels, w0 = _inputs(c, seed, device)
    k = tr["passes_per_call"]
    hist = ref.train(x, labels, w0, c["lr"], FIRST_CALLS * k, below)[::k]
    return {"program": {"grads": mean_grads(hist, c["lr"], k)},
            "reference": {"grads": reference_grads(
                x, labels, hist[:-1], c["lr"], k, stated)}}


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch.core import nn2sql
    from repro_torch.core.engine import Engine
    from repro_torch.data import one_hot_labels

    ctx.mark("imports")
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    x, labels, w0 = _inputs(c, ctx.seed, dev)
    ctx.mark("inputs")
    spec = nn2sql.MLPSpec(c["n_rows"], c["n_features"], c["n_hidden"],
                          c["n_classes"], lr=c["lr"])
    graph = nn2sql.build_graph(spec)
    engine = Engine(tr["engine"], device=dev)
    per_call = tr["passes_per_call"]
    objects = {"engine": engine, "nn2sql": nn2sql}
    if ctx.on_built:
        ctx.on_built(objects)
    y = one_hot_labels(labels, c["n_classes"], device=dev)
    history = [w0]
    for i in range(FIRST_CALLS):
        w, _ = nn2sql.train(graph, history[-1], x, y, per_call, engine)
        harness.synchronize(dev)
        ctx.mark(f"call {i + 1}")
        history.append(w)
    state = {"w": history[-1]}

    def unit(_):
        state["w"], _ = nn2sql.train(graph, state["w"], x, y, per_call,
                                     engine)

    units, secs, setup_s, reading, probes = harness.measured(ctx, unit,
                                                             objects)
    passes = units * per_call
    peak = harness.peak_bytes(dev)
    t0 = time.perf_counter()
    program = {"grads": mean_grads(history, c["lr"], per_call)}
    del state, graph, engine, x, y
    x, labels, _ = _inputs(c, ctx.seed, dev)
    readings = {"program": program, "reference": {"grads": reference_grads(
        x, labels, history[:-1], c["lr"], per_call)}}
    numbers = compare.train_numbers(program, readings["reference"])
    flops = counts.mlp_pass_flops(c, c["n_rows"])
    return harness.Outcome(
        setup_s=setup_s, window_s=secs, units=passes,
        end_to_end={tr["rate_metric"]: (passes * c["n_rows"] / secs,
                                        "rows/s")},
        peak_bytes=peak, numbers=numbers,
        scale={"units": passes, "model_flops": flops * passes},
        reading=reading, probes=probes, check_s=time.perf_counter() - t0,
        readings=readings)
