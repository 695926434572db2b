"""Per-IR-node SQL profiler: a profiled execution mode for ``SQLEngine``.

An ordinary evaluation runs ONE statement (plus spool steps for
multi-referenced subplans), so the engine's own timing can only attribute
to *stages* (ingest / render / execute / decode).  The profiler exploits
the spooled :class:`repro_torch.core.sqlgen.Plan` machinery with the spool
threshold forced to 1: **every** non-leaf IR node materialises as its own
``create temp table _sp_<node>`` step, so each step's wall time is that
node's self-time (children are already tables by the time it runs).  Per
step the profiler records

* **self time** — the create-statement wall clock,
* **rows / bytes** — ``count(*)`` (relational: × 24 bytes/cell-tuple;
  array: ``sum(length(m))`` of the codec),
* **parsed EXPLAIN** — the engine's plan for the node's statement
  (``EXPLAIN QUERY PLAN`` on sqlite, ``EXPLAIN`` on duckdb),
* **per-node dag signature** — the structural hash of the subDAG rooted at
  the node, so topologically identical nodes group across captures,

and emits the per-IR-node cost table both as a text report
(:meth:`ProfileResult.report`) and as a ``profile_nodes`` relation in the
traced database (:func:`write_profile_nodes`) — a flamegraph of the DAG
you can ``GROUP BY kind`` over (:data:`NODE_SQL`).

Fidelity note: the profiled mode materialises every intermediate, so the
engine cannot pipeline producer into consumer — the *sum* of node times
approximates (usually slightly exceeds) the one-statement cost, while the
*distribution* is what the ordinary plan genuinely spends per subplan.
Profiling overhead (row counts, byte probes, EXPLAIN capture) is measured
separately and reported as the ``probe`` stage, so the attribution
accounting (Σ named nodes + stages over wall time, the ≥95% acceptance
bar) stays honest.
"""
from __future__ import annotations

import dataclasses
import time

from ..core import autodiff
from ..core import expr as E
from ..core import sqlgen
from .tracer import tracer_of

#: column layout of the in-database per-node cost relation
PROFILE_NODE_COLUMNS = (
    ("node", "text"), ("kind", "text"), ("shape", "text"),
    ("self_us", "double precision"), ("rows", "integer"),
    ("bytes", "integer"), ("pct", "double precision"),
    ("node_signature", "text"), ("fused_members", "integer"),
    ("sql_head", "text"), ("explain_text", "text"),
)

#: the SQL recipe: cost by IR node kind over the profile relation
NODE_SQL = (
    "select kind, count(*) as n, sum(self_us) / 1e3 as total_ms,\n"
    "       sum(rows) as rows, sum(pct) as pct\n"
    "  from profile_nodes group by kind order by total_ms desc"
)

#: characters of rendered SQL kept per node in the relation/report
_SQL_HEAD = 160


def _node_kind(node: E.Expr, members: int = 1) -> str:
    kind = type(node).__name__
    if isinstance(node, E.Map) and node.fn is not None:
        kind = f"Map[{node.fn.name}]"
    if members > 1:
        kind = f"{kind}+fused({members})"
    return kind


@dataclasses.dataclass
class NodeCost:
    """One IR node's share of a profiled evaluation."""

    node: str                 # render-time CTE/table name
    kind: str                 # IR class (Map nodes carry the fn name)
    shape: str
    self_s: float
    rows: int
    bytes: int
    pct: float = 0.0          # share of total query time (nodes + tail)
    signature: str = ""       # dag_signature of the subDAG at this node
    fused_members: int = 1    # >1: this step rendered a fused region
    sql_head: str = ""
    explain_text: str = ""


@dataclasses.dataclass
class ProfileResult:
    """Outcome of :func:`profile_evaluate`: outputs + the cost table."""

    outputs: list             # decoded root matrices (same as evaluate())
    nodes: list               # NodeCost, hottest first
    stages: dict              # stage name -> seconds (ingest/render/…)
    wall_s: float
    dag_signature: str
    dialect: str
    rows_returned: int

    @property
    def attributed_s(self) -> float:
        return sum(n.self_s for n in self.nodes) + sum(self.stages.values())

    @property
    def attribution(self) -> float:
        """Fraction of profiled wall time on named nodes/stages (the
        acceptance criterion asks ≥ 0.95)."""
        return (self.attributed_s / self.wall_s) if self.wall_s else 0.0

    def by_kind(self) -> dict:
        agg: dict[str, dict] = {}
        for n in self.nodes:
            d = agg.setdefault(n.kind, {"count": 0, "self_s": 0.0,
                                        "rows": 0, "pct": 0.0})
            d["count"] += 1
            d["self_s"] += n.self_s
            d["rows"] += n.rows
            d["pct"] += n.pct
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]["self_s"]))

    def as_dict(self, top: int | None = None) -> dict:
        """JSON-serialisable summary (the benchmark reports embed this)."""
        nodes = self.nodes[:top] if top else self.nodes
        return {
            "dag_signature": self.dag_signature,
            "dialect": self.dialect,
            "wall_s": self.wall_s,
            "attribution": self.attribution,
            "rows_returned": self.rows_returned,
            "stages_s": dict(self.stages),
            "by_kind": self.by_kind(),
            "nodes": [{"node": n.node, "kind": n.kind, "shape": n.shape,
                       "self_ms": n.self_s * 1e3, "rows": n.rows,
                       "bytes": n.bytes, "pct": n.pct} for n in nodes],
        }

    def report(self, top: int | None = None) -> str:
        """Aligned text cost table, hottest node first."""
        nodes = self.nodes[:top] if top else self.nodes
        width = max([len(n.node) for n in nodes] + [4])
        kwidth = max([len(n.kind) for n in nodes] + [4])
        lines = [
            f"profile of {self.dag_signature[:16]} ({self.dialect}): "
            f"{self.wall_s * 1e3:.1f} ms wall, "
            f"{self.attribution:.1%} attributed",
            f"{'node':<{width}} {'kind':<{kwidth}} {'shape':>9} "
            f"{'self_ms':>9} {'rows':>7} {'bytes':>9} {'pct':>6}",
        ]
        for n in nodes:
            lines.append(
                f"{n.node:<{width}} {n.kind:<{kwidth}} {n.shape:>9} "
                f"{n.self_s * 1e3:>9.2f} {n.rows:>7} {n.bytes:>9} "
                f"{n.pct:>5.1f}%")
        if top and len(self.nodes) > top:
            rest = self.nodes[top:]
            lines.append(f"… {len(rest)} more nodes, "
                         f"{sum(n.self_s for n in rest) * 1e3:.2f} ms")
        stages = ", ".join(f"{k} {v * 1e3:.1f} ms"
                           for k, v in sorted(self.stages.items(),
                                              key=lambda kv: -kv[1]))
        lines.append(f"stages: {stages}")
        return "\n".join(lines)


def _step_bytes(adapter, table: str, rows: int, representation: str) -> int:
    if representation == "array":
        got = adapter.execute(
            f"select coalesce(sum(length(m)), 0) from {table}")
        return int(got[0][0] or 0)
    return rows * 24          # one (i, j, v) tuple ≈ 3 × 8-byte values


def profile_evaluate(engine, roots: list, env: dict) -> ProfileResult:
    """Profiled counterpart of ``SQLEngine.evaluate``: same outputs, plus
    the per-IR-node cost table.  Renders the DAG with every non-leaf node
    spooled (``spool_threshold=1``), times each ``create temp table`` step
    individually, and merges row counts, byte probes, per-node EXPLAIN
    output and per-node dag signatures.

    Works with or without an active tracer; when one is collecting, each
    node step additionally emits a ``profile.node`` span (so profiled runs
    show up in Chrome-trace and ``trace_spans`` exports)."""
    adapter = engine.adapter
    dialect = engine.dialect
    rep = engine.representation
    tr = tracer_of(engine, adapter)
    stages: dict[str, float] = {}

    t_wall0 = time.perf_counter()
    with tr.span("profile.evaluate", dialect=dialect.name,
                 representation=rep) as root_sp:
        t0 = time.perf_counter()
        engine._write_env(roots, env)
        stages["ingest"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        order = E.topo_order(*roots)
        nm = sqlgen.assign_names(order)
        node_by_name = {nm[id(n)]: n for n in order}
        regions, _skip = sqlgen.fuse_dag(roots) if engine.fuse \
            else ({}, set())
        plan = sqlgen.render_plan(
            roots, select=sqlgen.multi_root_tail(roots, dialect),
            dialect=dialect, fuse=engine.fuse, spool=True, spool_threshold=1)
        sig = sqlgen.dag_signature(roots)
        stages["render"] = time.perf_counter() - t0

        nodes: list[NodeCost] = []
        probe_s = 0.0
        for table, sql in plan.steps:
            node = node_by_name.get(table[len("_sp_"):])
            members = len(regions[id(node)][0]) \
                if node is not None and id(node) in regions else 1
            kind = _node_kind(node, members) if node is not None else "?"
            shape = "x".join(str(d) for d in node.shape) \
                if node is not None else ""
            with tr.span("profile.node", node=table[4:], kind=kind) as sp:
                t0 = time.perf_counter()
                adapter.execute(f"drop table if exists {table}")
                adapter.execute(sql)
                self_s = time.perf_counter() - t0
            # measurement probes — profiling overhead, booked separately
            t0 = time.perf_counter()
            rows = int(adapter.execute(
                f"select count(*) from {table}")[0][0])
            nbytes = _step_bytes(adapter, table, rows, rep)
            body = sql.split("\n", 1)[1] if "\n" in sql else sql
            try:
                explain = adapter.explain_sql(body)
            except Exception:
                explain = ""
            node_sig = sqlgen.dag_signature([node])[:16] \
                if node is not None else ""
            probe_s += time.perf_counter() - t0
            sp.set(self_us=round(self_s * 1e6, 3), rows=rows)
            nodes.append(NodeCost(
                node=table[4:], kind=kind, shape=shape, self_s=self_s,
                rows=rows, bytes=nbytes, signature=node_sig,
                fused_members=members,
                sql_head=" ".join(body[:_SQL_HEAD].split()),
                explain_text=explain))

        t0 = time.perf_counter()
        rows_out = adapter.execute(plan.sql)
        stages["tail"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        outputs = engine._decode(rows_out, roots)
        stages["decode"] = time.perf_counter() - t0
        stages["probe"] = probe_s

        query_s = sum(n.self_s for n in nodes) + stages["tail"]
        for n in nodes:
            n.pct = (100.0 * n.self_s / query_s) if query_s else 0.0
        nodes.sort(key=lambda n: -n.self_s)
        wall_s = time.perf_counter() - t_wall0
        root_sp.set(nodes=len(nodes), rows_returned=len(rows_out),
                    wall_ms=round(wall_s * 1e3, 3))

    return ProfileResult(outputs=outputs, nodes=nodes, stages=stages,
                         wall_s=wall_s, dag_signature=sig,
                         dialect=dialect.name, rows_returned=len(rows_out))


def profile_value_and_grad(engine, loss, wrt: list, env: dict
                           ) -> ProfileResult:
    """Profile one training-iteration evaluation: the loss plus its
    Algorithm-1 gradients — exactly the multi-root DAG a ``train.in_db``
    step (or ``value_and_grad_fn`` call) executes."""
    grads = autodiff.gradients(loss, wrt)
    return profile_evaluate(engine, [loss] + [grads[v] for v in wrt], env)


def write_profile_nodes(adapter, result: ProfileResult,
                        table: str = "profile_nodes") -> int:
    """Store the per-node cost table as a relation in the profiled
    database (replacing any previous capture); returns the row count.
    Duck-typed like ``write_trace_spans`` — query with :data:`NODE_SQL`
    on the same connection that ran the workload."""
    adapter.create_table(table, PROFILE_NODE_COLUMNS)
    adapter.bulk_insert(table, [
        (n.node, n.kind, n.shape, round(n.self_s * 1e6, 3), n.rows,
         n.bytes, n.pct, n.signature, n.fused_members, n.sql_head,
         n.explain_text)
        for n in result.nodes])
    return len(result.nodes)
