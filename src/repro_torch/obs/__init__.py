"""Tracing and metrics for the port: copies of the JAX package's pure-Python
``obs/tracer.py`` and of the histogram and time-series part of
``obs/metrics.py``.

Zero-cost by default: the active tracer is a no-op singleton until
:func:`install`/:func:`use` swaps a collecting one in (or an engine is
given ``tracer=...``).  The ``metric_points`` relation, exporters,
profiler, regression gate and report of ``repro.obs`` come with the port's
in-database tier.
"""
from .metrics import Histogram, MetricPoint
from .tracer import (NOOP_SPAN, NullTracer, Span, Tracer, current, install,
                     tracer_of, use)

__all__ = [
    "Span", "Tracer", "NullTracer", "NOOP_SPAN",
    "current", "install", "use", "tracer_of",
    "Histogram", "MetricPoint",
]
