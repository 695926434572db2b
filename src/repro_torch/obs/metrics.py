"""Histogram metrics and the ``metric_points`` time-series relation.

Two shapes of numeric telemetry ride the tracer next to spans:

``Histogram``
    Distribution sketch over fixed **log-spaced buckets** — p50/p95/p99
    without per-sample storage.  A value lands in bucket
    ``floor(log(v) / log(GROWTH))`` (``GROWTH = 2**(1/8)``), so memory is
    one counter per occupied power-of-1.09 band and the relative error of
    any reported percentile is bounded by ``sqrt(GROWTH) - 1`` (~4.4%).
    ``Tracer.observe(name, value)`` feeds one; the engine observes
    per-statement execution time, serving observes decode-step latency.

``MetricPoint`` / ``write_metric_points``
    An append-only time-series: training loss, gradient norm, plan-cache
    hit rate, rows ingested, serving tokens/s — one ``(seq, t, metric,
    step, value, labels)`` record per observation, appended by
    ``db/train.py``, ``SQLEngine`` and ``serving/engine.py`` each step.
    :func:`write_metric_points` pivots the series into a ``metric_points``
    relation *inside the traced database* (same stance as
    ``trace_spans``): training curves become a ``GROUP BY metric`` away.

Both are collected only when a collecting tracer is active — the
:class:`~repro_torch.obs.tracer.NullTracer` no-ops ``observe``/``point``.
"""
from __future__ import annotations

import dataclasses
import json
import math

#: per-bucket growth factor: 8 buckets per octave — percentile values are
#: exact to within sqrt(GROWTH) ≈ 4.5% relative error
GROWTH = 2.0 ** 0.125

_LOG_GROWTH = math.log(GROWTH)

#: column layout of the in-database time-series relation
METRIC_POINT_COLUMNS = (
    ("seq", "integer"), ("t_us", "double precision"), ("metric", "text"),
    ("step", "integer"), ("value", "double precision"), ("labels", "text"),
)

#: the SQL recipe: one summary row per metric over the time-series relation
METRIC_SQL = (
    "select metric, count(*) as n, min(value) as lo, max(value) as hi,\n"
    "       avg(value) as mean\n"
    "  from metric_points group by metric order by metric"
)


class Histogram:
    """Log-spaced-bucket distribution sketch (no per-sample storage).

    Not synchronised — the owning :class:`~repro_torch.obs.tracer.Tracer` calls
    ``observe`` under its lock.  Non-positive values are counted in a
    dedicated underflow bucket (they have no logarithm) and reported as
    the exact ``min`` when they dominate a percentile.
    """

    __slots__ = ("counts", "n", "total", "vmin", "vmax", "underflow")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.underflow = 0           # values <= 0

    def observe(self, value) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.underflow += 1
            return
        idx = int(math.floor(math.log(v) / _LOG_GROWTH))
        self.counts[idx] = self.counts.get(idx, 0) + 1

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0–100): geometric bucket midpoint,
        clamped to the observed [min, max] so the tails are exact."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(self.n * p / 100.0))
        if rank <= self.underflow:
            return self.vmin
        cum = self.underflow
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= rank:
                mid = math.exp((idx + 0.5) * _LOG_GROWTH)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> dict:
        """Summary dict — what ``Tracer.histograms`` and the Chrome-trace
        export carry per metric."""
        if self.n == 0:
            return {"count": 0}
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.total / self.n,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


@dataclasses.dataclass(frozen=True)
class MetricPoint:
    """One time-series observation (``t`` on the tracer's clock, so points
    align with span timestamps in the same capture)."""

    seq: int
    t: float
    metric: str
    step: int | None
    value: float
    labels: dict

    def as_row(self) -> tuple:
        return (self.seq, round(self.t * 1e6, 3), self.metric, self.step,
                self.value, json.dumps(self.labels, default=str,
                                       sort_keys=True))


def write_metric_points(adapter, tracer, table: str = "metric_points") -> int:
    """Store the collected time-series as a relation in the target database
    (replacing any previous capture); returns the row count.  Duck-typed
    like ``write_trace_spans``: any object with ``create_table`` +
    ``bulk_insert`` works, so the points land in the engine that produced
    them and :data:`METRIC_SQL` runs on the same connection."""
    points = list(tracer.points)
    adapter.create_table(table, METRIC_POINT_COLUMNS)
    adapter.bulk_insert(table, [p.as_row() for p in points])
    return len(points)


def percentiles_from_values(values, ps=(50, 90, 95, 99)) -> dict:
    """Exact percentiles of a raw value list (nearest-rank) — what the
    report CLI computes when it has the ``metric_points`` rows rather than
    a live histogram."""
    vs = sorted(float(v) for v in values)
    if not vs:
        return {f"p{p}": 0.0 for p in ps}
    return {f"p{p}": vs[min(len(vs) - 1,
                            max(0, math.ceil(len(vs) * p / 100.0) - 1))]
            for p in ps}
