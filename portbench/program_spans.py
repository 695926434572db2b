"""What the program's own spans and counters say about the traced window.

The traced window is one ``torch.profiler`` session, and a program whose
``repro_torch.obs`` keeps the sums of the session it ran under
(``obs.profiled().totals``: a span name's count, host seconds, numeric
attributes and device milliseconds) leaves them there for the readers of
the per-layer metrics that name a span or a counter.  Each reading is a
sum over the session divided by the window's units (``Observed.units``:
passes or steps), and is None where the session holds no unit span (a
program without these spans, or a session that ran no unit): such a
metric is left out of the line."""
from __future__ import annotations


def session():
    """The tracer of the program's most recent profiler session, or None
    where the program keeps none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    profiled = getattr(obs, "profiled", None)
    return profiled() if profiled else None


def _totals(unit: str):
    """The session's sums by span name, or None where it holds no ``unit``
    span."""
    totals = getattr(session(), "totals", None)
    if not totals or unit not in totals:
        return None
    return totals


def host_ms(obs, name: str, unit: str):
    """Host milliseconds a unit inside the spans called ``name``."""
    totals = _totals(unit)
    if totals is None:
        return None
    t = totals.get(name)
    return 1e3 * (t.seconds if t else 0.0) / obs.units


def device_ms(obs, name: str, unit: str):
    """Milliseconds a unit of the stream between the CUDA events of the
    spans called ``name``; None where any of them has no device time."""
    totals = _totals(unit)
    if totals is None or name not in totals:
        return None
    ms = totals[name].device_ms
    return None if ms is None else ms / obs.units


def attr_sum(obs, name: str, attr: str, unit: str):
    """The sum of attribute ``attr`` over the spans called ``name``, a
    unit; None where none of them carries it."""
    totals = _totals(unit)
    if totals is None or name not in totals:
        return None
    value = totals[name].attrs.get(attr)
    return None if value is None else value / obs.units


def counter_share(part: str, whole: str, unit: str):
    """100 x counter ``part`` / counter ``whole`` over the session; None
    where ``whole`` counted nothing."""
    if _totals(unit) is None:
        return None
    counters = session().counters
    if not counters.get(whole):
        return None
    return 100.0 * counters.get(part, 0) / counters[whole]
