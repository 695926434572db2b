"""Render an observability capture as a terminal report (PyTorch port of
``repro.obs.report``, pure Python).

    python -m repro_torch.obs.report trace.json    # Chrome-trace export
    python -m repro_torch.obs.report run.db        # traced database
    python -m repro_torch.obs.report run.db --top 15

Accepts either artifact the exporters produce — a Chrome-trace JSON
(:func:`repro_torch.obs.export.write_chrome_trace`) or a database file whose
engine ran under tracing and received the ``trace_spans`` /
``profile_nodes`` / ``metric_points`` relations — and prints the same
three sections from both:

* **stage breakdown** — per-span-name totals, dominant first, with the
  share of top-level wall time attributed,
* **hottest IR nodes** — the top-N rows of the per-node profiler cost
  table (when a profiled run was captured),
* **metric percentiles** — histogram snapshots (from the trace export) or
  exact p50/p90/p95/p99 recomputed from the ``metric_points`` rows.

The detection is by content, not extension: a file starting with the
SQLite magic (or openable by duckdb) is treated as a database, JSON as a
trace export.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import metrics as _metrics

_SQLITE_MAGIC = b"SQLite format 3\x00"


# ---------------------------------------------------------------------------
# capture loading: either artifact → one normalised dict
# ---------------------------------------------------------------------------

def _rows(conn, sql: str) -> list:
    try:
        cur = conn.execute(sql)
        return cur.fetchall()
    except Exception:
        return []                 # relation absent in this capture


def _load_db(path: str) -> dict:
    """Read the exported relations from a traced sqlite/duckdb file."""
    with open(path, "rb") as f:
        magic = f.read(16)
    if magic.startswith(_SQLITE_MAGIC):
        import sqlite3
        conn = sqlite3.connect(path)
    else:
        try:
            import duckdb
        except ImportError:
            raise SystemExit(f"{path}: not JSON, not sqlite, and the "
                             f"duckdb module is unavailable")
        conn = duckdb.connect(path)
    try:
        spans = [{"name": n, "parent_id": p, "dur_us": d}
                 for _sid, p, n, _path, _t0, d, _tid, _attrs in
                 _rows(conn, "select span_id, parent_id, name, path, t0_us,"
                             " dur_us, thread, attrs from trace_spans")]
        nodes = [{"node": r[0], "kind": r[1], "shape": r[2],
                  "self_us": r[3], "rows": r[4], "bytes": r[5], "pct": r[6]}
                 for r in _rows(conn, "select node, kind, shape, self_us,"
                                      " rows, bytes, pct from profile_nodes"
                                      " order by self_us desc")]
        points: dict[str, list[float]] = {}
        for metric_, value in _rows(
                conn, "select metric, value from metric_points"):
            points.setdefault(metric_, []).append(float(value))
        hists = {name: dict(_metrics.percentiles_from_values(vals),
                            count=len(vals),
                            mean=sum(vals) / len(vals),
                            min=min(vals), max=max(vals))
                 for name, vals in points.items()}
    finally:
        conn.close()
    return {"kind": "database", "spans": spans, "nodes": nodes,
            "histograms": hists}


def _load_trace(path: str, payload: dict) -> dict:
    """Normalise a Chrome-trace export (``write_chrome_trace`` output)."""
    events = payload.get("traceEvents", [])
    # interval containment per tid rebuilds the parent relation the flat
    # event list dropped: an event is a root iff no other event encloses it
    spans = []
    by_tid: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        by_tid.setdefault(e.get("tid", 0), []).append(e)
    for tid_events in by_tid.values():
        for e in tid_events:
            t0, t1 = e["ts"], e["ts"] + e.get("dur", 0.0)
            enclosed = any(
                o is not e and o["ts"] <= t0
                and o["ts"] + o.get("dur", 0.0) >= t1
                and (o["ts"], -(o["ts"] + o.get("dur", 0.0)))
                != (t0, -t1)
                for o in tid_events)
            spans.append({"name": e["name"],
                          "parent_id": 1 if enclosed else None,
                          "dur_us": e.get("dur", 0.0)})
    nodes = [{"node": e.get("args", {}).get("node", "?"),
              "kind": e.get("args", {}).get("kind", "?"),
              "shape": "", "self_us": e.get("dur", 0.0),
              "rows": e.get("args", {}).get("rows"),
              "bytes": None, "pct": None}
             for e in events if e.get("name") == "profile.node"]
    nodes.sort(key=lambda n: -(n["self_us"] or 0.0))
    other = payload.get("otherData", {})
    hists = dict(other.get("histograms", {}))
    points: dict[str, list[float]] = {}
    for p in other.get("metricPoints", []):
        points.setdefault(p["metric"], []).append(float(p["value"]))
    for name, vals in points.items():
        hists.setdefault(name, dict(
            _metrics.percentiles_from_values(vals), count=len(vals),
            mean=sum(vals) / len(vals), min=min(vals), max=max(vals)))
    return {"kind": "chrome-trace", "spans": spans, "nodes": nodes,
            "histograms": hists}


def load_capture(path: str) -> dict:
    """Path → ``{kind, spans, nodes, histograms}`` regardless of artifact
    flavour (trace JSON vs traced database file)."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(_SQLITE_MAGIC) or not head.lstrip()[:1] in (b"{",
                                                                   b"["):
        return _load_db(path)
    with open(path) as f:
        return _load_trace(path, json.load(f))


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_stage_table(spans: list, top: int) -> list[str]:
    agg: dict[str, dict] = {}
    root_us = 0.0
    child_us = 0.0
    for s in spans:
        if s["parent_id"] is None:
            root_us += s["dur_us"] or 0.0
        else:
            child_us += s["dur_us"] or 0.0
        d = agg.setdefault(s["name"], {"count": 0, "total_us": 0.0})
        d["count"] += 1
        d["total_us"] += s["dur_us"] or 0.0
    ordered = sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:top]
    if not ordered:
        return ["  (no spans captured)"]
    width = max(len(k) for k, _ in ordered)
    lines = [f"  {'span':<{width}} {'count':>6} {'total_ms':>10}"]
    for name, d in ordered:
        lines.append(f"  {name:<{width}} {d['count']:>6} "
                     f"{d['total_us'] / 1e3:>10.2f}")
    if root_us:
        lines.append(f"  top-level wall {root_us / 1e3:.2f} ms, "
                     f"{min(child_us / root_us, 1.0):.1%} in child spans")
    return lines


def _fmt_node_table(nodes: list, top: int) -> list[str]:
    nodes = nodes[:top]
    if not nodes:
        return ["  (no profiled run in this capture — see "
                "SQLEngine.profile / repro_torch.obs.profiler)"]
    width = max(max(len(str(n["node"])) for n in nodes), 4)
    kwidth = max(max(len(str(n["kind"])) for n in nodes), 4)
    lines = [f"  {'node':<{width}} {'kind':<{kwidth}} {'self_ms':>9} "
             f"{'rows':>7} {'pct':>6}"]
    for n in nodes:
        pct = "" if n["pct"] is None else f"{n['pct']:.1f}%"
        rows = "" if n["rows"] is None else str(n["rows"])
        lines.append(f"  {n['node']:<{width}} {n['kind']:<{kwidth}} "
                     f"{(n['self_us'] or 0.0) / 1e3:>9.2f} {rows:>7} "
                     f"{pct:>6}")
    return lines


def _fmt_hist_table(hists: dict) -> list[str]:
    if not hists:
        return ["  (no histogram/metric-point data in this capture)"]
    width = max(max(len(k) for k in hists), 6)
    lines = [f"  {'metric':<{width}} {'count':>6} {'mean':>10} "
             f"{'p50':>10} {'p95':>10} {'p99':>10} {'max':>10}"]
    for name in sorted(hists):
        h = hists[name]
        if not h.get("count"):
            continue

        def g(key):
            v = h.get(key)
            return "-" if v is None else f"{v:.4g}"

        lines.append(f"  {name:<{width}} {h['count']:>6} {g('mean'):>10} "
                     f"{g('p50'):>10} {g('p95'):>10} {g('p99'):>10} "
                     f"{g('max'):>10}")
    return lines


def render(capture: dict, top: int = 10) -> str:
    """The three-section text report of one capture."""
    lines = [f"== observability report ({capture['kind']}) =="]
    lines.append("\n-- stage breakdown (per span name) --")
    lines += _fmt_stage_table(capture["spans"], top)
    lines.append(f"\n-- hottest IR nodes (top {top}) --")
    lines += _fmt_node_table(capture["nodes"], top)
    lines.append("\n-- metric percentiles --")
    lines += _fmt_hist_table(capture["histograms"])
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Print stage breakdown, hottest IR nodes and metric "
                    "percentiles from a Chrome-trace JSON or a traced "
                    "database file.")
    ap.add_argument("path", help="trace.json or sqlite/duckdb database")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per section (default 10)")
    args = ap.parse_args(argv)
    print(render(load_capture(args.path), top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
