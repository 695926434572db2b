"""SQL dialects for the in-database execution backend.

The transpiler (``core.sqlgen``) renders the expression DAG against a
*dialect* object so the same generator serves several engines (§6 of the
paper evaluates DuckDB, HyPer and PostgreSQL; we target the engines reachable
from Python):

``Sql92Dialect``
    The paper's verbatim SQL-92: ``generate_series`` table function,
    ``exp`` / ``greatest`` builtins.  This is the golden-test dialect — its
    output matches the listings' structure exactly.

``SqliteDialect``
    stdlib ``sqlite3``, always available.  Two deviations are needed:

    * ``generate_series`` is a loadable extension sqlite3 does not ship, so
      constant matrices are built from an inline ``WITH RECURSIVE`` series
      (the emulation forces the top-level ``WITH`` to say ``RECURSIVE``);
    * ``exp`` and ``greatest`` are not built in — they are registered as
      deterministic Python UDFs on every connection (``prepare``).

    SQLite additionally restricts recursive CTEs: the recursive table may
    appear exactly once, in the *top-level* FROM clause of the recursive
    select — never inside a subquery ("circular reference") — and recursion
    is row-at-a-time queue semantics.  Listing 7's relational training query
    (which re-reads the whole previous weight *table* through a nested WITH)
    is therefore inexpressible; the training loop instead runs the paper's
    *array-data-type* variant (Listing 10): the whole weight state rides in
    ONE row of array-typed columns, and the matrix algebra is provided by
    registered UDFs over a JSON array encoding — ``create_function`` being
    sqlite's analogue of the paper's §5 DuckDB array-type extension.

``DuckDBDialect``
    Used when the ``duckdb`` package is importable (``pip install
    repro[db]``).  Stock SQL-92 rendering works unchanged (DuckDB has
    ``generate_series``, ``exp``, ``greatest``), and the Listing 7 / 10
    training queries are rendered by ``core.sqlgen`` verbatim.

``ArrayDialect``
    The paper's §5 *array data type* as a first-class fourth dialect
    (``representation = "array"``): one row per matrix, UDF calls per IR
    node, recursive-CTE scans over one array-typed state row.  See the
    class docstring and ``core.sqlgen``'s array renderer.
"""
from __future__ import annotations

import base64
import collections
import json
import math
import os

import numpy as np

from ..core import expr as E

try:  # optional dependency, gated — never required
    import duckdb  # type: ignore

    HAVE_DUCKDB = True
except ImportError:  # pragma: no cover - exercised when duckdb is absent
    duckdb = None
    HAVE_DUCKDB = False


# ---------------------------------------------------------------------------
# JSON array codec — the "array data type" as sqlite sees it
# ---------------------------------------------------------------------------

def matrix_to_json(x) -> str:
    """Encode a matrix as the array data type: row-major values + dims.
    This is the STORAGE codec — what ``write_matrix_array`` puts in the
    one-row array tables and what the documentation (paper §5) shows."""
    a = np.asarray(x, dtype=np.float64)
    return json.dumps({"r": a.shape[0], "c": a.shape[1],
                       "d": a.reshape(-1).tolist()})


def _matrix_to_wire(x) -> str:
    """The intra-query WIRE codec: ``b:<r>,<c>;<base64 float64 bytes>``.

    UDF→UDF exchange inside one statement never touches storage, so the
    array extension trades the human-readable JSON for a binary codec
    there — encode/decode is a memcpy + base64 pass instead of per-float
    text formatting, which dominated the recursive-training iteration
    (``json.dumps``+``json.loads`` were ~80% of its wall time).  base64's
    alphabet avoids the ``|``/``,`` separators of the scan string
    aggregation, and ``mrowcat``'s ``split(':', 1)`` keeps the payload
    intact.  NaN/±inf ride the IEEE bytes exactly — no printf spelling.
    ``json_to_matrix`` sniffs the prefix and accepts both codecs."""
    a = np.ascontiguousarray(x, dtype=np.float64)
    return (f"b:{a.shape[0]},{a.shape[1]};"
            + base64.b64encode(a.tobytes()).decode("ascii"))


def json_to_matrix(s) -> np.ndarray:
    """Decode either array codec (JSON storage or binary wire format)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    if s.startswith("b:"):
        head, payload = s[2:].split(";", 1)
        r, c = head.split(",")
        a = np.frombuffer(base64.b64decode(payload), dtype=np.float64)
        return a.reshape(int(r), int(c))
    o = json.loads(s)
    return np.asarray(o["d"], dtype=np.float64).reshape(o["r"], o["c"])


def _wrap2(f):
    return lambda x, y: _matrix_to_wire(
        f(json_to_matrix(x), json_to_matrix(y)))


def _wrap1(f):
    return lambda x: _matrix_to_wire(f(json_to_matrix(x)))


# -- zoo-tier array semantics (numpy twins of core.dense.eval_node) ---------

def _np_topk_mask(a: np.ndarray, k) -> np.ndarray:
    """0/1 indicator of each row's k largest entries, ties toward the
    smaller column index — the exact order of ``dense.topk_mask`` and the
    relational ``order by v desc, j asc`` rank."""
    c = a.shape[1]
    gt = (a[:, None, :] > a[:, :, None]).sum(-1)
    tri = np.tril(np.ones((c, c), dtype=bool), -1)
    eq = ((a[:, None, :] == a[:, :, None]) & tri[None]).sum(-1)
    return ((gt + eq) < int(k)).astype(np.float64)


def _np_row_shift(a: np.ndarray, offset) -> np.ndarray:
    offset = int(offset)
    if offset == 0:
        return a
    out = np.zeros_like(a)
    if abs(offset) >= a.shape[0]:
        return out
    if offset > 0:
        out[offset:] = a[:-offset]
    else:
        out[:offset] = a[-offset:]
    return out


def _udf_mreduce(m: str, kind: str, axis) -> str:
    a = json_to_matrix(m)
    red = a.sum if kind == "sum" else a.max
    return _matrix_to_wire(red(axis=int(axis), keepdims=True))


def _udf_msoftmax(m: str) -> str:
    a = json_to_matrix(m)
    e = np.exp(a - a.max(axis=1, keepdims=True))
    return _matrix_to_wire(e / e.sum(axis=1, keepdims=True))


def _udf_mgather(x: str, idx: str) -> str:
    a = json_to_matrix(x)
    s = json_to_matrix(idx)[:, 0].astype(np.int64)
    if s.size and (s.min() < 0 or s.max() >= a.shape[0]):
        raise ValueError(f"mgather index out of range: valid rows "
                         f"0..{a.shape[0] - 1}")
    return _matrix_to_wire(a[s])


def _udf_mscatter(x: str, idx: str, n_rows) -> str:
    a = json_to_matrix(x)
    s = json_to_matrix(idx)[:, 0].astype(np.int64)
    n_rows = int(n_rows)
    if s.size and (s.min() < 0 or s.max() >= n_rows):
        # np.add.at would wrap negative indices silently — mirror mgather
        # (and eager dense evaluation), which raise on the contract breach
        raise ValueError(f"mscatter index out of range: valid rows "
                         f"0..{n_rows - 1}")
    out = np.zeros((n_rows, a.shape[1]))
    np.add.at(out, s, a)
    return _matrix_to_wire(out)


def _udf_mrow(m: str, t) -> str:
    """Row ``t`` (1-based) as a (1, C) matrix — the scan CTE's state row."""
    t = int(t)
    return _matrix_to_wire(json_to_matrix(m)[t - 1:t, :])


def _udf_mmaxind(x: str, red: str) -> str:
    """The argmax indicator of a cached keepdims max (``ReduceDeriv``):
    broadcasting handles both axes."""
    return _matrix_to_wire(
        (json_to_matrix(x) == json_to_matrix(red)).astype(np.float64))


def _udf_mrecurstep(a: str, s: str, b: str, t, trans) -> str:
    """One step of the matrix-valued scan (``MatRecurrence``): slice block
    ``t`` (1-based) out of the (T·D, D) stack, return the (1, D) row
    ``s · A_t + b_t`` (``trans`` ≠ 0 uses A_tᵀ — the Algorithm-1 adjoint
    scan's transposed coefficients).  Keeping the matvec inside one scalar
    call is what lets the array dialect run the scan as a genuine
    recursive CTE: the recursive member stays aggregate-free."""
    t = int(t)
    av, sv, bv = json_to_matrix(a), json_to_matrix(s), json_to_matrix(b)
    d = av.shape[1]
    blk = av[(t - 1) * d:t * d, :]
    if int(trans):
        blk = blk.T
    return _matrix_to_wire(sv @ blk + bv[t - 1:t, :])


def _udf_mstepouter(x: str, y: str) -> str:
    """The stacked per-step outer product (``StepOuter``): x (T, K),
    y (T, J) → (T·K, J) with out[(t-1)K+k, j] = x[t,k]·y[t,j]."""
    xv, yv = json_to_matrix(x), json_to_matrix(y)
    return _matrix_to_wire(
        (xv[:, :, None] * yv[:, None, :]).reshape(-1, yv.shape[1]))


def _udf_mcellcat(concat, r, c) -> str:
    """Reassemble a CELL relation from concatenated ``i,j,v`` tags (the
    packed MatRecurrence lowering's child ingestion): order-independent,
    missing cells zero-fill — the outer-join semantics of the dense
    relation invariant.  ``%.17g`` tags round-trip float64 exactly."""
    out = np.zeros((int(r), int(c)))
    if concat:
        for tok in concat.split("|"):
            i, j, v = tok.split(",")
            try:
                out[int(i) - 1, int(j) - 1] = float(v)
            except ValueError as exc:
                raise ValueError(
                    f"mcellcat: unparseable cell tag {tok!r} — the packed "
                    f"codec expects '%.17g' or nan/inf spellings") from exc
    return _matrix_to_wire(out)


def _udf_mcell(m: str, i, j) -> float:
    """One cell (1-based) of an array codec — the packed scan's unpivot."""
    return float(json_to_matrix(m)[int(i) - 1, int(j) - 1])


def _udf_mrowcat(concat) -> str:
    """Reassemble a scan trajectory from the concatenated ``t:<codec>``
    tags (``group_concat(cast(t as text) || ':' || s, '|')``): split,
    sort by t, vstack.  Order-independent — forward scans, reverse scans
    and duckdb's unordered ``string_agg`` all land in the same matrix.
    This scalar UDF replaces the former ``magg_rows`` Python aggregate:
    duckdb has no Python aggregate API, but native string aggregation +
    one scalar call it can run."""
    if concat is None:  # empty scan (never rendered, but NULL-safe)
        return _matrix_to_wire(np.zeros((0, 0)))
    rows = []
    for tok in concat.split("|"):
        t, m = tok.split(":", 1)
        rows.append((int(t), m))
    rows.sort()
    return _matrix_to_wire(np.vstack([json_to_matrix(m) for _t, m in rows]))


def _udf_msum(concat) -> str:
    """Matrix sum over a ``'|'``-joined concatenation of array codecs
    (``msum(group_concat(m, '|'))``) — the array-representation AllReduce
    reducer of ``db/shard.py``: per-shard gradient rows are string-
    aggregated per weight relation and summed in ONE scalar call.  ``'|'``
    is collision-free: neither codec (base64 wire, JSON) emits it."""
    if concat is None:  # empty group (never rendered, but NULL-safe)
        return _matrix_to_wire(np.zeros((0, 0)))
    parts = [json_to_matrix(tok) for tok in concat.split("|")]
    out = parts[0].astype(np.float64, copy=True)
    for p in parts[1:]:
        out += p
    return _matrix_to_wire(out)


#: name → (nargs, python impl).  These are the matrix operations of the
#: paper's §5 array extension; ``core.sqlgen.array_call_expr`` (and the
#: ``training_query_array_calls`` recursion built on it) renders expression
#: DAGs as nested calls over exactly these names.
ARRAY_UDFS: dict[str, tuple[int, object]] = {
    "mm": (2, _wrap2(lambda a, b: a @ b)),
    "madd": (2, _wrap2(lambda a, b: a + b)),
    "msum": (1, _udf_msum),
    "msub": (2, _wrap2(lambda a, b: a - b)),
    "mhad": (2, _wrap2(lambda a, b: a * b)),
    "mscale": (2, lambda c, x: _matrix_to_wire(c * json_to_matrix(x))),
    "mt": (1, _wrap1(lambda a: a.T)),
    "mconst": (3, lambda r, c, v: _matrix_to_wire(np.full((int(r), int(c)), v))),
    "mmean": (1, lambda x: float(json_to_matrix(x).mean())),
    # elementwise maps and their derivatives (Algorithm 1's f / f')
    "msig": (1, _wrap1(lambda a: 1.0 / (1.0 + np.exp(-a)))),
    "msigd": (1, _wrap1(lambda a: a * (1.0 - a))),        # from cached f(x)
    "msqr": (1, _wrap1(lambda a: a * a)),
    "msqrd": (1, _wrap1(lambda a: 2.0 * a)),
    "mrelu": (1, _wrap1(lambda a: np.maximum(a, 0.0))),
    "mrelud": (1, _wrap1(lambda a: (a > 0.0).astype(np.float64))),
    "mone_minus": (1, _wrap1(lambda a: 1.0 - a)),
    "mrecip": (1, _wrap1(lambda a: 1.0 / a)),
    "mrecipd": (1, _wrap1(lambda a: -(a * a))),           # from cached f(x)
    # zoo tier IR nodes — the array-dialect lowering of RowReduce /
    # Softmax / ArgTopK / Gather / Scatter / RowShift and the scan-state
    # helpers of the Recurrence recursive CTE
    "mreduce": (3, _udf_mreduce),
    "msoftmax": (1, _udf_msoftmax),
    "mtopk": (2, lambda m, k: _matrix_to_wire(_np_topk_mask(json_to_matrix(m),
                                                           k))),
    "mgather": (2, _udf_mgather),
    "mscatter": (3, _udf_mscatter),
    "mrowshift": (2, lambda m, off: _matrix_to_wire(
        _np_row_shift(json_to_matrix(m), off))),
    "mrow": (2, _udf_mrow),
    "mmaxind": (2, _udf_mmaxind),
    # matrix-valued recurrence tier: the scan step, the stacked outer
    # product of its VJP, and the portable trajectory reassembly
    "mrecurstep": (5, _udf_mrecurstep),
    "mstepouter": (2, _udf_mstepouter),
    "mrowcat": (1, _udf_mrowcat),
    "mcellcat": (3, _udf_mcellcat),
    "mcell": (3, _udf_mcell),
}


# ---------------------------------------------------------------------------
# UDF memoization
# ---------------------------------------------------------------------------
#
# ``training_query_array_calls`` inlines every shared subexpression (the
# recursion is one query text, there is no CSE across the inlined copies),
# so the engine evaluates the SAME pure UDF call — same name, same JSON
# codec arguments — many times per iteration.  Every ARRAY_UDFS entry is a
# pure function of its arguments, so a byte-bounded memo over
# ``(name, *args)`` turns that duplication factor into cache hits.

class _ByteLRU:
    """LRU keyed on UDF call signatures, bounded by total result bytes."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        try:
            value, _n = self._d[key]
        except KeyError:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key, value) -> None:
        nbytes = len(value) if isinstance(value, str) else 8
        if nbytes > self.max_bytes:
            return
        old = self._d.pop(key, None)
        if old is not None:
            self._bytes -= old[1]
        self._d[key] = (value, nbytes)
        self._bytes += nbytes
        while self._bytes > self.max_bytes:
            _k, (_v, n) = self._d.popitem(last=False)
            self._bytes -= n


_UDF_CACHE: _ByteLRU | None = None


def _udf_cache() -> _ByteLRU | None:
    """The process-wide UDF memo (``REPRO_UDF_CACHE_MB``, default 256;
    0 disables).  Shared across connections — the UDFs are pure, so a
    hit from another engine's workload is still correct."""
    global _UDF_CACHE
    if _UDF_CACHE is None:
        mb = float(os.environ.get("REPRO_UDF_CACHE_MB", "256"))
        _UDF_CACHE = _ByteLRU(int(mb * 1024 * 1024)) if mb > 0 else None
    return _UDF_CACHE


def _memoized(name: str, fn):
    """Wrap a pure ARRAY_UDFS impl with the byte-bounded memo.  Results
    are cached only on success; calls with non-scalar/str arguments (none
    exist today) bypass the cache rather than risk an unhashable key."""

    def wrapper(*args):
        cache = _udf_cache()
        if cache is None or not all(
                isinstance(a, (str, int, float)) or a is None for a in args):
            return fn(*args)
        key = (name, *args)
        value = cache.get(key)
        if value is None:
            value = fn(*args)
            cache.put(key, value)
        return value

    return wrapper


# ---------------------------------------------------------------------------
# dialects
# ---------------------------------------------------------------------------

def _register_sqlite_udfs(conn) -> None:
    """The scalar builtins sqlite lacks + the whole UDF array extension —
    shared by the sqlite and array dialects.  All scalars: the scan
    reassembly is native string aggregation + the ``mrowcat`` scalar, so
    no Python aggregate exists anywhere (duckdb has no aggregate API —
    one registration surface serves both engines)."""
    conn.create_function("exp", 1, math.exp, deterministic=True)
    conn.create_function("greatest", 2, max, deterministic=True)
    for name, (nargs, fn) in ARRAY_UDFS.items():
        conn.create_function(name, nargs, _memoized(name, fn),
                             deterministic=True)


def _register_duckdb_udfs(conn) -> None:  # pragma: no cover - needs duckdb
    """Register the array extension on a duckdb connection.  duckdb's
    ``create_function`` needs explicit types for lambdas; aggregates have
    no Python API — which is why the scan reassembly renders as native
    ``group_concat`` + the ``mrowcat`` scalar, so the Recurrence (and
    MatRecurrence) CTEs execute on duckdb with no Python aggregate."""
    try:
        from duckdb.typing import DOUBLE, VARCHAR
        types = {"mscale": ([DOUBLE, VARCHAR], VARCHAR),
                 "mconst": ([DOUBLE, DOUBLE, DOUBLE], VARCHAR),
                 "mmean": ([VARCHAR], DOUBLE),
                 "mreduce": ([VARCHAR, VARCHAR, DOUBLE], VARCHAR),
                 "mtopk": ([VARCHAR, DOUBLE], VARCHAR),
                 "mscatter": ([VARCHAR, VARCHAR, DOUBLE], VARCHAR),
                 "mrowshift": ([VARCHAR, DOUBLE], VARCHAR),
                 "mrow": ([VARCHAR, DOUBLE], VARCHAR),
                 "mrecurstep": ([VARCHAR, VARCHAR, VARCHAR, DOUBLE, DOUBLE],
                                VARCHAR),
                 "mcellcat": ([VARCHAR, DOUBLE, DOUBLE], VARCHAR),
                 "mcell": ([VARCHAR, DOUBLE, DOUBLE], DOUBLE)}
    except ImportError:  # older duckdb
        types = {}
    for name, (nargs, fn) in ARRAY_UDFS.items():
        params, ret = types.get(name, ([VARCHAR] * nargs, VARCHAR)) \
            if types else (None, None)
        fn = _memoized(name, fn)
        try:
            if params is not None:
                conn.create_function(name, fn, params, ret)
            else:
                conn.create_function(name, fn)
        except Exception:
            continue  # register what we can; Listing 7 needs none


class Sql92Dialect:
    """The paper's SQL-92 as written in the listings (golden dialect)."""

    name = "sql92"
    #: which matrix representation the rendered SQL computes over:
    #: ``"relational"`` — one ``{[i, j, v]}`` tuple per cell (Listing 4);
    #: ``"array"`` — ONE row per matrix, an array-typed column (Listing 10)
    representation = "relational"
    #: whether constant matrices need the RECURSIVE keyword on the WITH
    series_is_recursive = False
    #: MatRecurrence rendering — ``"columns"``: the pure-SQL recursive CTE
    #: carrying the state row as D columns (golden, but its O(D²)
    #: coefficient references multiply under sqlite's substitution-based
    #: CTE expansion); ``"packed"``: children packed once into array
    #: codecs (``mcellcat``), stepped by ``mrecurstep`` — what the
    #: executable engines run (see ``core.sqlgen._mat_scan_ctes_packed``)
    mat_scan_rendering = "columns"
    #: how the engine expands multiply-referenced CTEs — ``"native"``:
    #: each CTE is evaluated once however often referenced (duckdb, and
    #: what SQL-92 text promises); ``"substitution"``: every textual
    #: reference re-executes the CTE body (sqlite).  Drives the default
    #: of ``SQLEngine(spool=...)``: under substitution, shared non-leaf
    #: nodes are materialised as temp tables before the main statement.
    cte_materialization = "native"

    # -- scalar rendering ---------------------------------------------------
    def map_sql(self, fn: E.MapFn, v: str) -> str:
        """Select-clause rendering of an elementwise function."""
        return fn.sql(v)

    def series_from(self, n: int, alias: str, col: str) -> str:
        """A from-clause term yielding the integers 1..n as column ``col``."""
        return (f"(select generate_series as {col}"
                f" from generate_series(1,{n})) {alias}")

    def const_select(self, rows: int, cols: int, value: float) -> str:
        """A constant matrix as the cross join of two series (Listing 5)."""
        return (f"select a.i, b.j, {value} as v\n"
                f"  from {self.series_from(rows, 'a', 'i')},\n"
                f"       {self.series_from(cols, 'b', 'j')}")

    def frame_from(self, rows: int, cols: int) -> str:
        """A from-clause term yielding the full (i, j) index frame — the
        outer-join skeleton that keeps Scatter/RowShift outputs dense.
        Explicit CROSS JOIN so a following LEFT JOIN's ON clause may
        reference both series (comma precedence differs across engines)."""
        return (f"{self.series_from(rows, 'a', 'i')} cross join\n"
                f"       {self.series_from(cols, 'b', 'j')}")

    def topk_mask_select(self, src: str, k: int) -> str:
        """The ArgTopK indicator: 1 where the cell ranks in its row's top
        ``k`` by value (ties toward the smaller j).  Strict SQL-92 has no
        window functions, so the rank is a correlated count — engines with
        windows override with ``row_number()``."""
        return (f"select m.i, m.j, case when (select count(*) from {src} n"
                f" where n.i = m.i and (n.v > m.v or (n.v = m.v and n.j < m.j))"
                f") < {k} then 1.0 else 0.0 end as v\n  from {src} as m")

    def topk_mask_select_b(self, src: str, k: int) -> str:
        """Batched ArgTopK indicator: the rank is per (request, row) — the
        correlated count additionally pins ``n.b = m.b`` so requests never
        see each other's values."""
        return (f"select m.b, m.i, m.j, case when (select count(*) from"
                f" {src} n where n.b = m.b and n.i = m.i and (n.v > m.v or"
                f" (n.v = m.v and n.j < m.j))) < {k} then 1.0 else 0.0 end"
                f" as v\n  from {src} as m")

    # -- connection preparation --------------------------------------------
    def prepare(self, conn) -> None:
        """Install anything the rendered SQL assumes (UDFs etc.)."""

    # -- capability flags ---------------------------------------------------
    #: can the engine run Listing 7 verbatim (recursive table in a nested
    #: WITH inside the recursive select)?
    supports_listing7 = True
    #: can the §5 array representation's UDF zoo run on this dialect's
    #: engines?  True wherever Python scalar functions register (sqlite,
    #: duckdb); False on server-side plpython-free backends (postgres),
    #: which must stay on the pure-SQL relational paths
    supports_array_udfs = True


def _windowed_topk_mask(src: str, k: int) -> str:
    """row_number() rendering of the ArgTopK indicator (sqlite ≥3.25 and
    duckdb both have window functions; the rank order matches the SQL-92
    correlated count and ``dense.topk_mask`` exactly)."""
    return (f"select q.i, q.j, case when q.rnk <= {k} then 1.0 else 0.0 end"
            f" as v\n  from (select i, j, v, row_number() over"
            f" (partition by i order by v desc, j asc) as rnk"
            f" from {src}) q")


def _windowed_topk_mask_b(src: str, k: int) -> str:
    """Batched twin of :func:`_windowed_topk_mask`: the window partitions
    by (b, i) so each request ranks its own rows."""
    return (f"select q.b, q.i, q.j, case when q.rnk <= {k} then 1.0 else"
            f" 0.0 end as v\n  from (select b, i, j, v, row_number() over"
            f" (partition by b, i order by v desc, j asc) as rnk"
            f" from {src}) q")


class SqliteDialect(Sql92Dialect):
    name = "sqlite"
    series_is_recursive = True
    supports_listing7 = False  # "circular reference" — see module docstring
    mat_scan_rendering = "packed"
    cte_materialization = "substitution"

    def series_from(self, n: int, alias: str, col: str) -> str:
        return (f"(with recursive s(x) as"
                f" (select 1 union all select x+1 from s where x < {n})"
                f" select x as {col} from s) {alias}")

    def topk_mask_select(self, src: str, k: int) -> str:
        return _windowed_topk_mask(src, k)

    def topk_mask_select_b(self, src: str, k: int) -> str:
        return _windowed_topk_mask_b(src, k)

    def prepare(self, conn) -> None:
        _register_sqlite_udfs(conn)


class DuckDBDialect(Sql92Dialect):
    name = "duckdb"
    mat_scan_rendering = "packed"

    def topk_mask_select(self, src: str, k: int) -> str:
        return _windowed_topk_mask(src, k)

    def topk_mask_select_b(self, src: str, k: int) -> str:
        return _windowed_topk_mask_b(src, k)

    def prepare(self, conn) -> None:  # pragma: no cover - needs the extra
        # generate_series / exp / greatest are native; the array UDFs back
        # the same Listing-10 rendering as sqlite (stock DuckDB has list
        # types but no matrix operators — the paper used a patched build).
        _register_duckdb_udfs(conn)


class PostgresDialect(Sql92Dialect):
    """Server-side postgres: the SQL-92 rendering runs nearly verbatim —
    ``generate_series`` / ``exp`` / ``greatest`` are native, window
    functions replace the correlated top-k count — and everything stays
    pure SQL (the server is plpython-free, so no UDF registration at all;
    ``supports_array_udfs = False`` keeps callers on the relational
    representation).  Listing 7 is off: postgres rejects the recursive
    self-reference inside a subquery of the recursive member ("recursive
    reference … must not appear within a subquery"), so training uses the
    stepped strategy.  CTEs materialise natively (each evaluated once
    however often referenced — postgres ≥ 12 inlines single-reference
    CTEs and materialises shared ones)."""

    name = "postgres"
    supports_listing7 = False  # recursive ref inside a subquery is rejected
    supports_array_udfs = False

    def topk_mask_select(self, src: str, k: int) -> str:
        return _windowed_topk_mask(src, k)

    def topk_mask_select_b(self, src: str, k: int) -> str:
        return _windowed_topk_mask_b(src, k)


class ArrayDialect(Sql92Dialect):
    """The array-typed representation as a first-class dialect (paper §5,
    Listing 10): every matrix — leaf table, CTE, query result — is ONE row
    whose single column ``m`` holds the JSON array codec, and every IR node
    is a call into the UDF array extension instead of a join over cells.
    The scans (``Recurrence``/``MatRecurrence``) are the exception: they
    render as recursive CTEs whose state is one array-typed row per step
    (``mrow``/``mrecurstep``), the Listing-7 machinery at matrix
    granularity, reassembled by native string aggregation + the
    ``mrowcat`` scalar.

    The dialect rides an existing *engine* connection — sqlite by
    default, duckdb for the whole IR including the scans (nothing needs
    a Python aggregate) — pass ``SQLEngine(dialect="array")``.
    """

    name = "array"
    representation = "array"
    series_is_recursive = False   # constants are mconst() calls, no series
    supports_listing7 = False     # training runs the Listing-10 recursion
    cte_materialization = "substitution"  # rides a sqlite engine by default

    def prepare(self, conn) -> None:
        import sqlite3

        if isinstance(conn, sqlite3.Connection):
            _register_sqlite_udfs(conn)
        else:  # pragma: no cover - needs duckdb
            _register_duckdb_udfs(conn)


_DIALECTS = {"sql92": Sql92Dialect, "sqlite": SqliteDialect,
             "duckdb": DuckDBDialect, "postgres": PostgresDialect,
             "array": ArrayDialect}


def get_dialect(name) -> Sql92Dialect:
    """Dialect registry: by name, or pass through an instance."""
    if isinstance(name, Sql92Dialect):
        return name
    try:
        return _DIALECTS[name]()
    except KeyError:
        raise ValueError(f"unknown dialect {name!r}; "
                         f"have {sorted(_DIALECTS)}") from None
