"""Benchmark-metric normalisation and the perf-regression comparison
(PyTorch port of ``repro.obs.regress``, pure Python).

Every ``BENCH_*.json`` carries (or, for files committed before this layer,
implies) a flat ``metrics`` block::

    "metrics": {
        "training.recursive_per_iter_s":
            {"value": 0.0489, "unit": "s", "direction": "lower"},
        "ingestion.pivot_speedup":
            {"value": 168.6, "unit": "x", "direction": "higher"},
        ...
    }

``direction`` says which way is better; an optional per-metric
``tolerance`` overrides the comparison-wide band.  :func:`compare` takes a
baseline and a fresh report, matches metrics by name, and flags a
regression only when the fresh value is worse by more than the tolerance
factor (default 1.5× — generous enough for CI-runner noise, tight enough
to catch a real slowdown).  :func:`delta_table` renders the result as a
readable delta table.

:func:`metrics_from_report` is the single extraction point: it prefers the
embedded ``metrics`` block and falls back to deriving the headline numbers
from the known report shapes of the five committed benchmarks, so the gate
works against baselines that predate the block.
"""
from __future__ import annotations

import dataclasses


def metric(value, unit: str = "s", direction: str = "lower",
           tolerance: float | None = None) -> dict:
    """One normalised headline number (helper for the benchmark scripts)."""
    m = {"value": float(value), "unit": unit, "direction": direction}
    if tolerance is not None:
        m["tolerance"] = float(tolerance)
    return m


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _legacy_metrics(report: dict) -> dict:
    """Headline metrics derived from pre-``metrics``-block report shapes
    (the committed baselines that predate the block)."""
    out: dict[str, dict] = {}

    def put(name, value, unit="s", direction="lower"):
        if isinstance(value, (int, float)) and value == value:
            out[name] = metric(value, unit, direction)

    ing = report.get("ingestion") or {}
    put("ingestion.pivot_speedup", ing.get("speedup"), "x", "higher")
    fg = report.get("forward_grad") or {}
    put("forward_grad.warm_s",
        fg.get("warm_s", fg.get("sqlite_warm_s")))
    put("forward_grad.cold_s",
        fg.get("cold_s", fg.get("sqlite_cold_s")))
    put("forward_grad.fused_speedup", fg.get("fused_speedup"), "x", "higher")
    trn = report.get("training") or {}
    put("training.recursive_per_iter_s", trn.get("recursive_per_iter_s"))
    trace = report.get("trace") or {}
    ti = trace.get("train_iteration") or trace
    put("trace.train_attribution", ti.get("attribution"), "frac", "higher")

    for r in report.get("results") or []:     # bench_array_vs_relational
        wl = r.get("workload")
        if not wl:
            continue
        put(f"{wl}.relational_s", r.get("relational_s"))
        put(f"{wl}.array_s", r.get("array_s"))
        put(f"{wl}.speedup_array", r.get("speedup_array"), "x", "higher")

    moe = report.get("moe") or {}             # bench_zoo_db
    put("moe.layer_sql_s", moe.get("layer_sql_s"))
    rwkv = report.get("rwkv") or {}
    put("rwkv.time_mix_sql_s", rwkv.get("time_mix_sql_s"))

    ssd = report.get("ssd") or {}             # bench_ssm_db
    put("ssd.relational_s", ssd.get("relational_s"))
    put("ssd.array_s", ssd.get("array_s"))
    lru = report.get("lru") or {}
    put("lru.relational_s", lru.get("relational_s"))
    put("lru.array_s", lru.get("array_s"))
    put("lru.grads_s", lru.get("grads_s"))
    return out


def metrics_from_report(report: dict) -> dict:
    """The normalised ``{name: {value, unit, direction, ...}}`` block of a
    benchmark report — embedded if present, derived for legacy shapes."""
    block = report.get("metrics")
    if isinstance(block, dict) and block:
        return {k: dict(v) for k, v in block.items()
                if isinstance(v, dict) and "value" in v}
    return _legacy_metrics(report)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Delta:
    """One metric's baseline-vs-fresh comparison."""

    name: str
    baseline: float | None
    fresh: float | None
    unit: str = "s"
    direction: str = "lower"
    ratio: float | None = None     # fresh / baseline
    tolerance: float = 1.5
    status: str = "ok"             # ok|improved|regressed|missing|new|skipped

    @property
    def failed(self) -> bool:
        return self.status in ("regressed", "missing")


def compare(baseline: dict, fresh: dict, tolerance: float = 1.5,
            gate_directions=("lower", "higher"),
            fail_on_missing: bool = True) -> list[Delta]:
    """Match two reports' metric blocks by name and judge each pair.

    A ``lower``-is-better metric regresses when ``fresh > baseline ×
    tolerance``; a ``higher``-is-better one when ``fresh < baseline /
    tolerance``.  Directions not in ``gate_directions`` are compared but
    never fail (``status="skipped"``) — the smoke gate times a reduced
    problem size, where absolute times only shrink but derived ratios
    (speedups) legitimately drop.  Fresh-only metrics report ``new``;
    baseline metrics the fresh run lost report ``missing`` (a deleted
    headline number is itself a regression unless ``fail_on_missing`` is
    off).  Per-metric ``tolerance`` keys override the global band."""
    base_m = metrics_from_report(baseline)
    fresh_m = metrics_from_report(fresh)
    deltas: list[Delta] = []
    for name in sorted(set(base_m) | set(fresh_m)):
        b, f = base_m.get(name), fresh_m.get(name)
        if b is None:
            deltas.append(Delta(name=name, baseline=None,
                                fresh=f["value"], unit=f.get("unit", "s"),
                                direction=f.get("direction", "lower"),
                                status="new"))
            continue
        direction = b.get("direction", "lower")
        unit = b.get("unit", "s")
        tol = float(b.get("tolerance", tolerance))
        if f is None:
            deltas.append(Delta(
                name=name, baseline=b["value"], fresh=None, unit=unit,
                direction=direction, tolerance=tol,
                status=("missing" if fail_on_missing
                        and direction in gate_directions else "skipped")))
            continue
        bv, fv = float(b["value"]), float(f["value"])
        ratio = (fv / bv) if bv else None
        d = Delta(name=name, baseline=bv, fresh=fv, unit=unit,
                  direction=direction, ratio=ratio, tolerance=tol)
        if direction not in gate_directions:
            d.status = "skipped"
        elif ratio is None:
            d.status = "ok"
        elif direction == "lower":
            d.status = ("regressed" if ratio > tol
                        else "improved" if ratio < 1.0 / tol else "ok")
        else:
            d.status = ("regressed" if ratio < 1.0 / tol
                        else "improved" if ratio > tol else "ok")
        deltas.append(d)
    return deltas


_MARK = {"ok": " ", "improved": "+", "regressed": "!",
         "missing": "!", "new": "·", "skipped": "~"}


def delta_table(deltas: list[Delta], title: str = "") -> str:
    """The readable comparison table CI prints and uploads."""
    width = max([len(d.name) for d in deltas] + [6])
    lines = []
    if title:
        lines.append(title)
    lines.append(f"  {'metric':<{width}} {'baseline':>12} {'fresh':>12} "
                 f"{'ratio':>7} {'status':>9}")

    def num(v):
        return "-" if v is None else f"{v:.6g}"

    for d in deltas:
        lines.append(
            f"{_MARK[d.status]} {d.name:<{width}} {num(d.baseline):>12} "
            f"{num(d.fresh):>12} "
            f"{('-' if d.ratio is None else f'{d.ratio:.2f}x'):>7} "
            f"{d.status:>9}")
    bad = [d for d in deltas if d.failed]
    lines.append(f"  {len(deltas)} metrics, "
                 f"{sum(1 for d in deltas if d.status == 'improved')} "
                 f"improved, {len(bad)} regressed"
                 + (f" ({', '.join(d.name for d in bad)})" if bad else ""))
    return "\n".join(lines)
