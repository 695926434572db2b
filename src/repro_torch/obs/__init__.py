"""Observability for the port: tracing, metrics, exporters, profiler
(PyTorch port of ``repro.obs``, pure Python).

:class:`~repro_torch.obs.tracer.Tracer` collects nested, attributed spans
from every layer of the in-database path (plan render, cache lookup, leaf
ingestion, query execution, result decode, training iterations) and from
serving (``serve.prefill``, ``serve.step``); counters, gauges, histograms
(``tracer.observe``) and the ``metric_points`` time series
(``tracer.point``) ride along.  The exporters turn a capture into a
Chrome-trace/Perfetto JSON or a ``trace_spans`` relation *inside the
traced database*; :mod:`~repro_torch.obs.profiler` is the per-IR-node
profiled execution mode (``SQLEngine.profile``);
:mod:`~repro_torch.obs.regress` compares benchmark ``metrics`` blocks
against baselines (the perf gate's comparison); ``python -m
repro_torch.obs.report`` prints all of it from a trace JSON or a traced
database.

Zero-cost by default: the active tracer is a no-op singleton until
:func:`install`/:func:`use` swaps a collecting one in (or an engine is
given ``tracer=...``).
"""
from .export import (STAGE_SQL, TRACE_SPAN_COLUMNS, chrome_trace,
                     stage_breakdown, summarize, write_chrome_trace,
                     write_trace_spans)
from .metrics import (METRIC_POINT_COLUMNS, METRIC_SQL, Histogram,
                      MetricPoint, percentiles_from_values,
                      write_metric_points)
from .profiler import (NODE_SQL, PROFILE_NODE_COLUMNS, NodeCost,
                       ProfileResult, profile_evaluate,
                       profile_value_and_grad, write_profile_nodes)
from .regress import (Delta, compare, delta_table, metric,
                      metrics_from_report)
from .tracer import (NOOP_SPAN, NullTracer, Span, Tracer, current, install,
                     tracer_of, use)

__all__ = [
    "Span", "Tracer", "NullTracer", "NOOP_SPAN",
    "current", "install", "use", "tracer_of",
    "chrome_trace", "write_chrome_trace", "write_trace_spans",
    "summarize", "stage_breakdown", "STAGE_SQL", "TRACE_SPAN_COLUMNS",
    "Histogram", "MetricPoint", "write_metric_points",
    "percentiles_from_values", "METRIC_SQL", "METRIC_POINT_COLUMNS",
    "NodeCost", "ProfileResult", "profile_evaluate",
    "profile_value_and_grad", "write_profile_nodes",
    "NODE_SQL", "PROFILE_NODE_COLUMNS",
    "Delta", "compare", "delta_table", "metric", "metrics_from_report",
]
