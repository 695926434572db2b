"""Exporters and aggregations over collected trace spans.

Three consumers, three shapes:

* **Chrome trace / Perfetto** — :func:`chrome_trace` renders the span list
  as the Trace Event Format (``"X"`` complete events, microsecond
  timestamps), loadable in ``chrome://tracing`` and https://ui.perfetto.dev.
* **the database itself** — :func:`write_trace_spans` pivots the spans into
  a ``trace_spans`` relation *inside the traced engine*, so the question
  "which stage dominates a training step" is a plain SQL query
  (:data:`STAGE_SQL`) against the same database that ran the workload —
  the SQL4NN "models are data you can query" premise applied to the
  engine's own telemetry.
* **benchmark reports** — :func:`summarize` (per-name totals) and
  :func:`stage_breakdown` (direct children of a root span, with the
  fraction of root wall time they attribute) — a per-stage report.
"""
from __future__ import annotations

import json

#: column layout of the in-database span relation (``write_trace_spans``)
TRACE_SPAN_COLUMNS = (
    ("span_id", "integer"), ("parent_id", "integer"), ("name", "text"),
    ("path", "text"), ("t0_us", "double precision"),
    ("dur_us", "double precision"), ("thread", "integer"), ("attrs", "text"),
)

#: the SQL recipe: per-stage totals over the span relation, dominant first
#: (run it against the same connection that executed the traced workload)
STAGE_SQL = (
    "select name, count(*) as n, sum(dur_us) / 1e3 as total_ms\n"
    "  from trace_spans where parent_id is not null\n"
    " group by name order by total_ms desc"
)


def _json_attrs(attrs: dict) -> str:
    """Attrs → JSON, numpy scalars and other exotica stringified."""
    return json.dumps(attrs, default=str, sort_keys=True)


def _tid_map(spans) -> dict:
    """Thread idents → small stable ints (Chrome wants readable tids)."""
    tids: dict = {}
    for s in spans:
        if s.tid not in tids:
            tids[s.tid] = len(tids)
    return tids


# ---------------------------------------------------------------------------
# Chrome trace / Perfetto
# ---------------------------------------------------------------------------

def chrome_trace(tracer) -> dict:
    """Span list → Trace Event Format dict (``"X"`` complete events)."""
    spans = list(tracer.spans)
    tids = _tid_map(spans)
    events = [{
        "name": s.name,
        "cat": "repro",
        "ph": "X",
        "ts": round(s.t0 * 1e6, 3),
        "dur": round(s.duration * 1e6, 3),
        "pid": 0,
        "tid": tids[s.tid],
        "args": {k: (v if isinstance(v, (int, float, str, bool))
                     or v is None else str(v))
                 for k, v in s.attrs.items()},
    } for s in spans]
    counters = tracer.counters
    gauges = tracer.gauges
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": counters, "gauges": gauges,
                          "histograms": tracer.histograms,
                          "metricPoints": [
                              {"seq": p.seq, "t_us": round(p.t * 1e6, 3),
                               "metric": p.metric, "step": p.step,
                               "value": p.value, "labels": p.labels}
                              for p in tracer.points]}}


def write_chrome_trace(tracer, path: str) -> str:
    """Write the Perfetto-loadable JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, indent=1, sort_keys=True)
    return path


# ---------------------------------------------------------------------------
# the trace_spans relation
# ---------------------------------------------------------------------------

def write_trace_spans(adapter, tracer, table: str = "trace_spans") -> int:
    """Store the finished spans as a relation in the target database
    (replacing any previous capture).  Returns the row count.

    The adapter is duck-typed (``create_table`` + ``bulk_insert``), so the
    spans land in whichever engine ran the workload — queryable with
    :data:`STAGE_SQL` on the very connection they measure."""
    spans = list(tracer.spans)
    tids = _tid_map(spans)
    adapter.create_table(table, TRACE_SPAN_COLUMNS)
    adapter.bulk_insert(table, [
        (s.span_id, s.parent_id, s.name, s.path,
         round(s.t0 * 1e6, 3), round(s.duration * 1e6, 3),
         tids[s.tid], _json_attrs(s.attrs))
        for s in spans])
    return len(spans)


# ---------------------------------------------------------------------------
# report aggregations
# ---------------------------------------------------------------------------

def summarize(tracer, top: int | None = None) -> dict:
    """Per-span-name aggregation: ``{name: {count, total_s, mean_s,
    max_s}}``, largest total first (``top`` caps the entries)."""
    agg: dict[str, dict] = {}
    for s in tracer.spans:
        d = agg.setdefault(s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        d["count"] += 1
        d["total_s"] += s.duration
        d["max_s"] = max(d["max_s"], s.duration)
    for d in agg.values():
        d["mean_s"] = d["total_s"] / d["count"]
    ordered = sorted(agg.items(), key=lambda kv: -kv[1]["total_s"])
    if top is not None:
        ordered = ordered[:top]
    return dict(ordered)


def stage_breakdown(tracer, root: str | None = None) -> dict:
    """Attribute a root span's wall time to its *direct* children, grouped
    by name — the per-stage section of the benchmark reports.

    ``root`` selects root spans by name (default: every parentless span).
    ``attribution`` is Σ(child durations) / Σ(root durations): the fraction
    of measured wall time the named stages account for (the acceptance
    criterion asks ≥ 0.9 for one MNIST training iteration)."""
    spans = list(tracer.spans)
    roots = [s for s in spans
             if (s.name == root if root is not None else s.parent_id is None)]
    root_ids = {s.span_id for s in roots}
    root_s = sum(s.duration for s in roots)
    stages: dict[str, dict] = {}
    covered = 0.0
    for s in spans:
        if s.parent_id not in root_ids:
            continue
        d = stages.setdefault(s.name, {"count": 0, "total_s": 0.0})
        d["count"] += 1
        d["total_s"] += s.duration
        covered += s.duration
    for d in stages.values():
        d["pct_of_root"] = (100.0 * d["total_s"] / root_s) if root_s else 0.0
    return {
        "root": root if root is not None else "<top-level>",
        "root_count": len(roots),
        "wall_s": root_s,
        "attributed_s": covered,
        "attribution": (covered / root_s) if root_s else 0.0,
        "stages": dict(sorted(stages.items(),
                              key=lambda kv: -kv[1]["total_s"])),
    }
