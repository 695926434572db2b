"""Observability for the port: tracing, metrics, exporters, profiler.

:class:`~repro_torch.obs.tracer.Tracer` collects nested, attributed spans
from every layer of the in-database path (plan render, cache lookup, leaf
ingestion, query execution, result decode, training iterations), from
serving (``serve.prefill``, ``serve.step``) and from the hot path the
benchmark times: ``nn2sql.iteration``, ``engine.evaluate``, ``rel.*``,
``kernels.<wrapper>`` with ``kernels.status_wait`` and ``kernels.launch``,
``train.step`` and its parts, the ``moe.*`` counters, ``py.gc``.
Counters (device tensors too), gauges, histograms (``tracer.observe``) and
the ``metric_points`` time series (``tracer.point``) ride along.  The
exporters turn a capture into a Chrome-trace/Perfetto JSON or a
``trace_spans`` relation *inside the traced database*;
:mod:`~repro_torch.obs.profiler` is the per-IR-node profiled execution mode
(``SQLEngine.profile``); :mod:`~repro_torch.obs.regress` compares benchmark
``metrics`` blocks against baselines (the perf gate's comparison);
``python -m repro_torch.obs.report`` prints all of it from a trace JSON or
a traced database.

Zero-cost by default: the active tracer is a no-op singleton until
:func:`install`/:func:`use` swaps a collecting one in (or an engine is
given ``tracer=...``), or a ``torch.profiler`` session records.  Under the
profiler every span is also a ``record_function`` range on the profiler's
own clock, and with no tracer installed the session's sums a span name
(:class:`~repro_torch.obs.tracer.Totals`) and its counters are kept in
:func:`profiled`; ``span(..., device=True)`` adds the stream's time
between two CUDA events (``Span.device_ms``).  To trace a run, install a
:class:`Tracer` (``with obs.use(obs.Tracer()): ...``, its ``spans`` then
exported by :func:`chrome_trace`) or run it under ``torch.profiler``
(read ``obs.profiled()`` after).  :mod:`~repro_torch.obs.tracer` says how.
"""
from .tracer import (NOOP_SPAN, NullTracer, SessionTracer, Span, Totals,
                     Tracer, current, device_allocs, epoch_clock,
                     in_backward, inc, install, profiled, span, tracer_of,
                     tracing, use)
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

__all__ = [
    "Span", "Tracer", "NullTracer", "NOOP_SPAN", "SessionTracer", "Totals",
    "current", "install", "use", "tracer_of",
    "span", "inc", "profiled", "tracing", "in_backward",
    "device_allocs", "epoch_clock",
    "chrome_trace", "write_chrome_trace", "write_trace_spans",
    "summarize", "stage_breakdown", "STAGE_SQL", "TRACE_SPAN_COLUMNS",
    "Histogram", "MetricPoint", "write_metric_points",
    "percentiles_from_values", "METRIC_SQL", "METRIC_POINT_COLUMNS",
    "NodeCost", "ProfileResult", "profile_evaluate",
    "profile_value_and_grad", "write_profile_nodes",
    "NODE_SQL", "PROFILE_NODE_COLUMNS",
    "Delta", "compare", "delta_table", "metric", "metrics_from_report",
]
