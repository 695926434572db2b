"""Trace an in-database training run — and query the trace *with SQL*.

The observability loop closed on itself: a :class:`repro_torch.obs.Tracer`
collects nested spans from every layer of the execution stack (leaf
ingestion, plan render + cache lookup, EXPLAIN capture, query execution,
result decode), then the spans are written back into the very database
that ran the workload as a ``trace_spans`` relation — so "which stage
dominates a training step" is answered by the engine itself, with the
same SQL surface that trained the model.

Also shows ``SQLEngine.stats`` (plan-cache hit/miss/eviction counters —
the LRU no longer evicts silently), the engine's EXPLAIN output for the
cached plan, the Chrome-trace export (load the JSON at
https://ui.perfetto.dev), the per-IR-node profiled execution mode
(``SQLEngine.profile_value_and_grad`` → ``profile_nodes`` relation), the
``metric_points`` time-series (training loss, grad norm, cache hit rate),
and the one-command terminal report over either artifact::

    python -m repro_torch.obs.report observe_in_db.trace.json
    python -m repro_torch.obs.report observe_in_db.sqlite

The weights and data are tensors on ``--device``; they cross to the
database at ingestion.  The trace JSON is written into the working
directory.

    PYTHONPATH=src python -m repro_torch.examples.observe_in_db
    PYTHONPATH=src python -m repro_torch.examples.observe_in_db --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import obs
from ..core import nn2sql
from ..db.adapter import connect
from ..db.plan_cache import PlanCache
from ..db.sql_engine import SQLEngine
from ..db.train import train_in_db
from ..device import resolve
from ..obs import report as obs_report

TRACE_PATH = "observe_in_db.trace.json"
N_ITERS = 10
spec = nn2sql.MLPSpec(n_rows=60, n_features=4, n_hidden=10, n_classes=3,
                      lr=0.1)


def iris_like(spec, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(spec.n_classes, spec.n_features)
    labels = rng.randint(0, spec.n_classes, spec.n_rows)
    x = centers[labels] + 0.08 * rng.randn(spec.n_rows, spec.n_features)
    return x.astype(np.float32), np.eye(spec.n_classes)[labels]


def observe(graph, weights, x, y) -> dict:
    """The traced run and every read of its capture, printed; returns the
    tracer, the engine's stats, the profile, the rows each SQL read gave
    and the trace file's path."""
    tracer = obs.Tracer()
    adapter = connect("sqlite")
    cache = PlanCache(path=None)

    # -- 1. trace a training run + a traced forward evaluation ---------------
    with obs.use(tracer):
        train_in_db(graph, weights, x, y, n_iters=N_ITERS, adapter=adapter,
                    plan_cache_=cache)
    eng = SQLEngine(adapter=adapter, plan_cache_=cache, tracer=tracer)
    try:
        env = {**weights, "img": x, "one_hot": y}
        eng.evaluate([graph.loss], env)
        eng.evaluate([graph.loss], env)  # warm

        # -- 2. the spans become a relation in the SAME database -------------
        n_spans = obs.write_trace_spans(adapter, tracer)
        print(f"wrote {n_spans} spans into trace_spans — per-stage totals "
              f"via SQL:\n")
        print("    " + obs.STAGE_SQL.replace("\n", "\n    "), "\n")
        stage_rows = adapter.execute(obs.STAGE_SQL)
        for name, count, total_ms in stage_rows:
            print(f"  {name:<22s} n={int(count):<4d} {total_ms:9.3f} ms")

        # -- 3. per-stage attribution of the training iteration --------------
        bd = obs.stage_breakdown(tracer, root="train.in_db")
        print(f"\ntrain.in_db: {bd['wall_s'] * 1e3:.2f} ms wall, "
              f"{bd['attribution']:.1%} attributed to named stages:")
        for stage, d in bd["stages"].items():
            print(f"  {stage:<22s} {d['pct_of_root']:5.1f}%")

        # -- 4. merged counters + the engine's own plan for the cached query -
        st = eng.stats
        print(f"\nSQLEngine.stats: cache {st['cache_hits']} hits / "
              f"{st['cache_misses']} misses / {st['cache_evictions']} "
              f"evictions; {st['queries']} queries, {st['ingest_bytes']} "
              f"bytes ingested")
        print("\nEXPLAIN QUERY PLAN of the cached forward query:")
        explain = eng.explain([graph.loss])
        for line in explain.splitlines()[:6]:
            print("  " + line)

        # -- 5. per-IR-node profile: every node its own timed temp-table step
        res = eng.profile_value_and_grad(graph.loss, [graph.w_xh, graph.w_ho],
                                         env)
        print(f"\nprofiled training-step DAG "
              f"({res.attribution:.1%} of wall attributed):")
        print(res.report(top=8))
        obs.write_profile_nodes(adapter, res)
        print("\ncost by IR node kind, via SQL on profile_nodes:")
        node_rows = adapter.execute(obs.NODE_SQL)[:5]
        for kind, n_, ms, rows, pct in node_rows:
            print(f"  {kind:<22s} n={int(n_):<3d} {ms:8.3f} ms  {pct:5.1f}%")

        # -- 6. the metric_points time-series lands in the database too ------
        n_points = obs.write_metric_points(adapter, tracer)
        print(f"\nwrote {n_points} metric points — per-metric summary via "
              f"SQL:")
        metric_rows = adapter.execute(obs.METRIC_SQL)
        for metric, cnt, lo, hi, mean in metric_rows:
            print(f"  {metric:<22s} n={int(cnt):<4d} mean={mean:.4g} "
                  f"[{lo:.4g}, {hi:.4g}]")
        h = tracer.histograms.get("db.execute_ms")
        if h:
            print(f"db.execute_ms histogram: n={h['count']} "
                  f"p50={h['p50']:.3f} p95={h['p95']:.3f} "
                  f"p99={h['p99']:.3f} ms")

        # -- 7. Perfetto-loadable export + the terminal report CLI -----------
        path = obs.write_chrome_trace(tracer, TRACE_PATH)
        print(f"\nChrome trace written to {path} (open in ui.perfetto.dev)")
        print("inspect either artifact with: "
              f"python -m repro_torch.obs.report {TRACE_PATH}")
        report = obs_report.render(obs_report.load_capture(path), top=5)
        print("\n" + report)
    finally:
        eng.close()
    return dict(tracer=tracer, rows=spec.n_rows, n_iters=N_ITERS,
                spans=n_spans, stage_rows=stage_rows, breakdown=bd, stats=st,
                explain=explain, profile=res, node_rows=node_rows,
                metric_points=n_points, metric_rows=metric_rows,
                trace_path=os.path.abspath(path), report=report)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    graph = nn2sql.build_graph(spec)
    weights = nn2sql.init_weights(spec, device=dev)
    x, y = (torch.as_tensor(a, device=dev) for a in iris_like(spec))
    return observe(graph, weights, x, y)


if __name__ == "__main__":
    main()
