"""Tracing and metrics for the port: the in-database stack, serving, and
the hot path that the benchmark times (the MLP's passes, the relational
engine, the kernels' wrappers, the LM training step, the MoE).

``Tracer``
    Nested spans with a context-manager API.  Spans are thread-safe (a
    thread-local stack keeps nesting per thread; finished spans land in one
    shared list) and carry free-form attributes set at open
    (``tracer.span("db.execute", sql=head)``) or later (``sp.set(rows=n)``).
    Counters and gauges ride the same object (``inc`` / ``gauge``), as do
    log-spaced-bucket histograms (``observe`` — p50/p95/p99 with no
    per-sample storage) and the ``metric_points`` time-series (``point`` —
    training loss, tokens/s, cache hit rate; see
    :mod:`repro_torch.obs.metrics`).  A counter may be fed a tensor
    (``inc("moe.dropped", (~keep).sum())``): the sum stays on the tensor's
    device and becomes a number only when ``counters`` is read.

``NullTracer``
    The zero-cost default.  ``span()`` returns a shared no-op singleton
    whose ``__enter__``/``__exit__``/``set`` do nothing — instrumented code
    runs one attribute lookup and an empty ``with`` per span.

**One clock with the profiler.**  A ``Tracer``'s default clock
(:func:`epoch_clock`) is Unix-epoch time from the wall clock, the time
base ``torch.profiler`` stamps its events with (``kineto_results.events()``
``start_ns``), so a span's ``t0``/``t1`` and the Chrome trace's ``ts`` line
up with the profiler's own events.  ``clock=`` stays injectable.

**The profiler bridge.**  While a ``torch.profiler`` session records, every
span also opens a ``record_function`` range of the span's name, so the
profiler's trace carries the program's spans; and with no tracer installed
the spans go to the session's own tracer, :func:`profiled`, which holds
the most recent session's sums of its spans and its counters (a new one
when a span opens under a new session).  So running the program under
``torch.profiler`` is enough to trace it, as PyTorch's own
``record_function`` marks work; ``install``/``use`` a :class:`Tracer` to
collect without the profiler.  With neither, :func:`span` returns the
shared no-op: no ``Span``, no ``record_function``, no CUDA event.  While a
session records, a ``gc.callbacks`` hook also records each cyclic
collection as a ``py.gc`` span (``generation``, ``collected``).

**The session's sums.**  The session's tracer (:class:`SessionTracer`)
keeps no span: it folds each finished span into its name's
:class:`Totals` (count, host seconds, the sums of its numeric
attributes, device milliseconds), so a long traced window holds a few
objects a span name and not one a span.

**Device-timed spans.**  ``span(name, device=True)`` records a pair of
CUDA timing events on the current stream at enter and exit (only while
tracing, only once CUDA is initialised); ``Span.device_ms`` reads the
milliseconds between them once both have completed.  Nothing synchronises.
That is the stream's time between the two points: the device's work
queued inside the span and whatever idle the host leaves there.

The hot path's spans (``span`` / ``inc`` of this module, which resolve the
tracer on each call): ``nn2sql.iteration``, ``engine.evaluate``,
``rel.pivot`` / ``rel.transpose`` / ``rel.matmul``, ``kernels.<wrapper>``
with children ``kernels.status_wait`` and ``kernels.launch``,
``train.step``, ``train.microbatch``, ``train.forward`` /
``train.backward`` (device), ``train.clip`` / ``train.update``, and the
counters ``moe.assignments`` / ``moe.dropped``, ``relmm.calls`` /
``relmm.<route>`` (``relational_matmul``'s schedule) and ``optim.elems`` /
``optim.fused`` (the elements a CUDA update touched, and those of them the
fused AdamW kernel updated).

The *active* tracer is a module global (``current()`` / ``install()`` /
the ``use()`` context manager); engines and adapters additionally accept a
``tracer`` attribute that overrides the global for their own spans
(:func:`tracer_of` resolves it).  Exporters live in
:mod:`repro_torch.obs.export`: Chrome-trace/Perfetto JSON, and the
``trace_spans`` relation written back *into the database being traced*, so
plain SQL answers "which stage dominates a training step".
"""
from __future__ import annotations

import gc
import itertools
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _prof

from . import metrics as _metrics

def epoch_clock() -> float:
    """Seconds since the Unix epoch, from the system's wall clock, which
    ``torch.profiler`` stamps its events with (their ``start_ns`` / 1e9).
    Not the monotonic clock plus an offset: where the wall clock is being
    slewed the two part by milliseconds within a second."""
    return time.time_ns() * 1e-9


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
                 "t0", "t1", "tid", "_closed", "_device", "_events",
                 "_device_ms", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 device: bool = False):
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
        self._device = device
        self._events = None
        self._device_ms = None
        self._range = None

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

    @property
    def device_ms(self) -> float | None:
        """Device milliseconds between the span's CUDA events: None for a
        span that recorded none, or while they have not completed."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            if end is not None and end.query():
                self._device_ms = start.elapsed_time(end)
                self._events = None
        return self._device_ms

    def _open(self, stack) -> None:
        """Stamp id, parent and start (and, while the profiler
        records, open the span's ``record_function`` range)."""
        tr = self.tracer
        self.tid = threading.get_ident()
        self.span_id = next(tr._ids)
        if stack:
            self.parent_id = stack[-1].span_id
            self.path = stack[-1].path + "/" + self.name
        self.t0 = tr._clock()
        if _prof._is_profiler_enabled:
            self._range = _prof.record_function(self.name).__enter__()
        if self._device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self._open(stack)
        stack.append(self)
        return self

    def _close(self, now) -> None:
        """Finalise once: stamp the end time, close the device events and
        the profiler range, and hand the span to its tracer.  Idempotent — a
        span force-closed during an enclosing span's abnormal unwind must
        not re-export if its own ``__exit__`` runs later out of order."""
        if self._closed:
            return
        self._closed = True
        if self.t1 is None:
            self.t1 = now
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.tracer._finish(self)

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
    device_ms = None
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

    def span(self, name: str, device: bool = False, **attrs):
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
    (the Chrome-trace golden file pins exporter output byte-for-byte); the
    default is :func:`epoch_clock`, the profiler's time base."""

    enabled = True

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else epoch_clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.spans: list[Span] = []
        self._counters: dict = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _metrics.Histogram] = {}
        self._points: list[_metrics.MetricPoint] = []

    # -- spans --------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device: bool = False, **attrs) -> Span:
        return Span(self, name, attrs, device)

    def _finish(self, span: Span) -> None:
        """Keep a finished span.  No lock: ``list.append`` is atomic, and
        a ``py.gc`` span may close while the tracer's lock is held on this
        thread."""
        self.spans.append(span)

    def current_path(self) -> str:
        """Slash-joined path of the innermost open span on this thread."""
        stack = self._stack()
        return stack[-1].path if stack else ""

    # -- counters / gauges --------------------------------------------------
    def inc(self, name: str, n=1) -> None:
        """Add ``n`` (a number, or a tensor summed on its own device) to
        the named counter."""
        if isinstance(n, torch.Tensor):
            n = n.detach()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    @property
    def counters(self) -> dict:
        """The counters as numbers: a tensor sum is read here, which waits
        for the work that made it, and is kept as the number from then on
        (so that the tracer holds no device memory for it)."""
        with self._lock:
            self._counters = {k: v.item() if isinstance(v, torch.Tensor)
                              else v for k, v in self._counters.items()}
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


class Totals:
    """One span name's sums over a session: how many spans finished, their
    host seconds, the sum of each numeric attribute, and the device
    milliseconds of those that recorded CUDA events."""

    __slots__ = ("count", "seconds", "attrs", "_timed", "_device_ms",
                 "_pending")

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self.attrs: dict = {}
        self._timed = 0
        self._device_ms = 0.0
        self._pending: list = []

    def add(self, span: Span) -> None:
        self.count += 1
        self.seconds += span.duration
        for k, v in span.attrs.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.attrs[k] = self.attrs.get(k, 0) + v
        if span._events is not None:
            self._timed += 1
            self._pending.append(span._events)
            self._resolve()

    def _resolve(self) -> None:
        """Fold in the event pairs that have completed (a query each, no
        wait), so that only the spans still queued keep theirs."""
        waiting = []
        for start, end in self._pending:
            if end.query():
                self._device_ms += start.elapsed_time(end)
            else:
                waiting.append((start, end))
        self._pending = waiting

    @property
    def device_ms(self) -> float | None:
        """The device milliseconds of the spans that recorded events: None
        where none did, or while any of them has not completed."""
        self._resolve()
        if not self._timed or self._pending:
            return None
        return self._device_ms


class SessionTracer(Tracer):
    """The tracer of one profiler session: spans fold into
    ``totals[name]`` (:class:`Totals`) as they finish, and ``spans`` stays
    empty; counters, gauges and the rest as :class:`Tracer` keeps them."""

    def __init__(self, clock=None):
        super().__init__(clock)
        self.totals: dict[str, Totals] = {}
        #: re-entrant: a ``py.gc`` span may finish inside another's fold
        self._fold = threading.RLock()

    def _finish(self, span: Span) -> None:
        with self._fold:
            t = self.totals.get(span.name)
            if t is None:
                t = self.totals[span.name] = Totals()
            t.add(span)

    def clear(self) -> None:
        super().clear()
        with self._fold:
            self.totals = {}


# ---------------------------------------------------------------------------
# the module-level active tracer, and the profiler session's
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_active: NullTracer = _NULL
#: the most recent profiler session's tracer, and that session's number
_session: NullTracer = _NULL
_session_number = -1
#: profiler sessions started in this process
_sessions = 0
#: re-entrant: a ``py.gc`` span may open while a thread holds it
_session_lock = threading.RLock()


def _count_session(start=_prof._run_on_profiler_start):
    """Wraps ``torch.autograd.profiler._run_on_profiler_start``, which
    every profiler session calls as it starts (PyTorch 2.1 and later), to
    number the sessions."""
    global _sessions
    _sessions += 1
    start()


_prof._run_on_profiler_start = _count_session


def _end_session(stop=_prof._run_on_profiler_stop):
    """Wraps ``torch.autograd.profiler._run_on_profiler_stop``: the ending
    session's counters are read into numbers, so that the tracer kept for
    :func:`profiled` holds no device memory after its session."""
    stop()
    if _session_number == _sessions:
        _session.counters


_prof._run_on_profiler_stop = _end_session


def _tracer() -> NullTracer:
    """Where spans go now: the installed tracer; else, while a profiler
    session records, that session's tracer (a new one for a new session);
    else the no-op."""
    global _session, _session_number
    if _active is not _NULL or not _prof._is_profiler_enabled:
        return _active
    if _session_number != _sessions:
        with _session_lock:
            if _session_number != _sessions:
                _session, _session_number = SessionTracer(), _sessions
    return _session


def current() -> NullTracer:
    """The active tracer: the installed one, else the recording profiler
    session's, else a :class:`NullTracer`."""
    return _tracer()


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
    else :func:`current`."""
    for o in objs:
        t = getattr(o, "tracer", None)
        if t is not None:
            return t
    return _tracer()


def profiled() -> NullTracer:
    """The tracer of the most recent profiler session: its spans' sums
    (``totals``) and its counters (a :class:`NullTracer` where that
    session collected none)."""
    return _session if _session_number == _sessions else _NULL


def tracing() -> bool:
    """Whether spans are collected now (a tracer installed, or a profiler
    session recording): the guard for work done only to feed a span or a
    counter."""
    return _active is not _NULL or _prof._is_profiler_enabled


def span(name: str, device: bool = False, **attrs):
    """A span of the current tracer; the shared no-op, made without a
    lookup beyond two globals, while nothing traces."""
    tr = _active
    if tr is _NULL:
        if not _prof._is_profiler_enabled:
            return NOOP_SPAN
        tr = _tracer()
    return tr.span(name, device, **attrs)


def inc(name: str, n=1) -> None:
    """Add ``n`` to a counter of the current tracer (nothing while nothing
    traces; guard the work that makes ``n`` with :func:`tracing`)."""
    _tracer().inc(name, n)


def in_backward() -> bool:
    """Whether autograd's engine is running a backward on this thread (a
    forward that activation checkpointing recomputes runs there)."""
    return torch._C._current_graph_task_id() != -1


def device_allocs(device) -> int | None:
    """The caching allocator's count of device allocations (``cudaMalloc``
    calls) on ``device`` while tracing; None otherwise, or off CUDA."""
    if not tracing() or torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory.memory_stats_as_nested_dict(device).get(
        "num_device_alloc")


_gc_open: list = []      # the py.gc span of the collection in progress


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a ``py.gc`` span for each cyclic collection
    while a profiler session records, in the installed tracer or the
    session's.  It makes no session tracer: a collection may start while
    one is being made, and one made here would take the spans of the
    threads that see it until the other replaced it."""
    if phase == "start":
        if not _prof._is_profiler_enabled:
            return
        tr = _active if _active is not _NULL else profiled()
        if tr is _NULL:
            return
        sp = Span(tr, "py.gc", {"generation": info["generation"]})
        sp._open(tr._stack())
        _gc_open.append(sp)
    elif _gc_open:
        sp = _gc_open.pop()
        sp.attrs["collected"] = info["collected"]
        sp._close(sp.tracer._clock())


gc.callbacks.append(_on_gc)
