"""Tracing and metrics for the in-database execution stack.

The engine's evaluation (§7 of the paper is *nothing but* runtime and
memory measurement) was a black box: the plan cache evicted silently, the
MNIST benchmark reported one end-to-end number with no per-stage
attribution.  This module is the instrument panel:

``Tracer``
    Nested spans with a context-manager API.  Spans are thread-safe (a
    thread-local stack keeps nesting per thread; finished spans land in one
    shared list under a lock) and carry free-form attributes set at open
    (``tracer.span("db.execute", sql=head)``) or later (``sp.set(rows=n)``).
    Counters and gauges ride the same object (``inc`` / ``gauge``), as do
    log-spaced-bucket histograms (``observe`` — p50/p95/p99 with no
    per-sample storage) and the ``metric_points`` time-series (``point`` —
    training loss, tokens/s, cache hit rate; see
    :mod:`repro_torch.obs.metrics`).

``NullTracer``
    The zero-cost default.  ``span()`` returns a shared no-op singleton
    whose ``__enter__``/``__exit__``/``set`` do nothing — instrumented code
    runs one attribute lookup and an empty ``with`` per span, so the
    disabled overhead on a warm ``SQLEngine.evaluate`` stays well under the
    2% budget (guarded by ``tests/test_obs.py``).

The *active* tracer is a module global (``current()`` / ``install()`` /
the ``use()`` context manager); engines and adapters additionally accept a
``tracer`` attribute that overrides the global for their own spans
(:func:`tracer_of` resolves it).  This is a copy of the JAX package's
``repro.obs.tracer``.  Exporters live in :mod:`repro_torch.obs.export`:
Chrome-trace/Perfetto JSON, and the ``trace_spans`` relation written back
*into the database being traced*, so plain SQL answers "which stage
dominates a training step".
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from . import metrics as _metrics


class Span:
    """One timed, attributed interval.  Context manager: entering records
    the start time and the position in the per-thread span stack (parent
    linkage + slash-joined ``path``); exiting records the end time and
    appends the finished span to the tracer's shared list.

    Exit is exception-safe: a raise inside the ``with`` closes the span
    with ``error``/``exc_type`` attributes, and any *abandoned* descendant
    still sitting on the thread-local stack (a span opened inside this one
    whose ``__exit__`` never ran — e.g. a generator torn down mid-flight)
    is force-closed and exported too, so one failed query can never leave
    the stack dirty for the next call."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id", "path",
                 "t0", "t1", "tid", "_closed")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = None
        self.parent_id = None
        self.path = name
        self.t0 = None
        self.t1 = None
        self.tid = None
        self._closed = False

    def set(self, **attrs) -> "Span":
        """Attach attributes to an open (or finished) span."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        """Seconds between enter and exit (0.0 while still open)."""
        if self.t0 is None or self.t1 is None:
            return 0.0
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        tr = self.tracer
        stack = tr._stack()
        self.tid = threading.get_ident()
        with tr._lock:
            tr._next_id += 1
            self.span_id = tr._next_id
        if stack:
            self.parent_id = stack[-1].span_id
            self.path = stack[-1].path + "/" + self.name
        stack.append(self)
        self.t0 = tr._clock()
        return self

    def _close(self, now) -> None:
        """Finalise once: stamp the end time and publish to the shared
        list.  Idempotent — a span force-closed during an enclosing span's
        abnormal unwind must not re-export if its own ``__exit__`` runs
        later out of order."""
        if self._closed:
            return
        self._closed = True
        if self.t1 is None:
            self.t1 = now
        with self.tracer._lock:
            self.tracer.spans.append(self)

    def __exit__(self, exc_type=None, exc=None, tb=None) -> bool:
        if self._closed:
            return False
        tr = self.tracer
        now = tr._clock()
        self.t1 = now
        if exc_type is not None:
            self.attrs.setdefault("error", True)
            self.attrs.setdefault("exc_type", exc_type.__name__)
        stack = tr._stack()
        # pop self — and close any abandoned descendants above it first,
        # marking them so the export shows where the unwind cut through.
        # (If self is not on this thread's stack at all, leave it alone.)
        if any(s is self for s in stack):
            while stack:
                top = stack.pop()
                if top is self:
                    break
                top.attrs.setdefault("abandoned", True)
                if exc_type is not None:
                    top.attrs.setdefault("error", True)
                    top.attrs.setdefault("exc_type", exc_type.__name__)
                top._close(now)
        self._close(now)
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.path!r}, {self.duration * 1e3:.3f} ms, "
                f"attrs={self.attrs!r})")


class _NoopSpan:
    """The shared do-nothing span of the disabled tracer."""

    __slots__ = ()
    duration = 0.0
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op (the default)."""

    enabled = False
    spans: tuple = ()

    def span(self, name: str, **attrs):
        return NOOP_SPAN

    def inc(self, name: str, n=1) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def observe(self, name: str, value) -> None:
        pass

    def point(self, metric: str, value, step=None, **labels) -> None:
        pass

    def current_path(self) -> str:
        return ""

    def clear(self) -> None:
        pass

    @property
    def counters(self) -> dict:
        return {}

    @property
    def gauges(self) -> dict:
        return {}

    @property
    def histograms(self) -> dict:
        return {}

    @property
    def points(self) -> tuple:
        return ()


class Tracer(NullTracer):
    """Collecting tracer.  ``clock`` is injectable for deterministic tests
    (the Chrome-trace golden file pins exporter output byte-for-byte)."""

    enabled = True

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self.spans: list[Span] = []
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _metrics.Histogram] = {}
        self._points: list[_metrics.MetricPoint] = []

    # -- spans --------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def current_path(self) -> str:
        """Slash-joined path of the innermost open span on this thread."""
        stack = self._stack()
        return stack[-1].path if stack else ""

    # -- counters / gauges --------------------------------------------------
    def inc(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    @property
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    @property
    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    # -- histograms / time-series -------------------------------------------
    def observe(self, name: str, value) -> None:
        """Feed one sample into the named log-spaced-bucket histogram
        (:class:`repro_torch.obs.metrics.Histogram` — p50/p95/p99 with no
        per-sample storage)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _metrics.Histogram()
            h.observe(value)

    def point(self, metric: str, value, step=None, **labels) -> None:
        """Append one time-series observation (training loss, tokens/s,
        cache hit rate …).  ``step`` is the caller's iteration counter;
        timestamps use the tracer clock so points align with spans."""
        with self._lock:
            self._points.append(_metrics.MetricPoint(
                seq=len(self._points), t=self._clock(), metric=metric,
                step=step, value=float(value), labels=labels))

    def histogram(self, name: str) -> _metrics.Histogram | None:
        """The live histogram object (None if nothing observed yet)."""
        with self._lock:
            return self._hists.get(name)

    @property
    def histograms(self) -> dict:
        """Snapshot per metric: count/sum/min/max/mean/p50/p90/p95/p99."""
        with self._lock:
            return {k: h.snapshot() for k, h in sorted(self._hists.items())}

    @property
    def points(self) -> list:
        with self._lock:
            return list(self._points)

    # -- lifecycle ----------------------------------------------------------
    def clear(self) -> None:
        """Drop finished spans, counters, gauges, histograms and metric
        points (open spans keep their stack so an enclosing ``with`` still
        closes cleanly)."""
        with self._lock:
            self.spans = []
            self._counters = {}
            self._gauges = {}
            self._hists = {}
            self._points = []


# ---------------------------------------------------------------------------
# the module-level active tracer
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_active: NullTracer = _NULL


def current() -> NullTracer:
    """The active tracer (a :class:`NullTracer` unless one is installed)."""
    return _active


def install(tracer=None) -> NullTracer:
    """Install ``tracer`` as the process-wide active tracer (``None``
    restores the zero-cost no-op default).  Returns the installed tracer."""
    global _active
    _active = tracer if tracer is not None else _NULL
    return _active


@contextmanager
def use(tracer):
    """Scope a tracer: active inside the ``with``, previous one restored
    after — how benchmarks and tests turn tracing on."""
    prev = _active
    install(tracer)
    try:
        yield tracer
    finally:
        install(prev)


def tracer_of(*objs) -> NullTracer:
    """Resolve the tracer for instrumented code: the first non-``None``
    ``tracer`` attribute among ``objs`` (engine- or adapter-level override),
    else the module-level active tracer."""
    for o in objs:
        t = getattr(o, "tracer", None)
        if t is not None:
            return t
    return _active
