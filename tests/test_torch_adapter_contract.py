"""Twin of ``tests/test_adapter_contract.py`` for the port's ``db.adapter``:
one contract, every backend the environment can open, held on the
behaviours the port's ``SQLEngine`` / ``relation_io`` / ``db.shard``
assume — param-style round trips, temp-table shadowing, concurrent
``executemany``, the shared generation registry — and, where the
reference test computes a value (the Algorithm-1 loss and gradient
query, three stepped training iterations), the port's value held against
the JAX package's on the same inputs as well.

``sqlite`` always; ``duckdb`` when the package is importable;
``postgres`` when ``psycopg2`` is importable and ``REPRO_PG_DSN`` points
at a server, as in the reference.  Tolerance: the reference's 1e-9 (both
packages render the same SQL and the database computes in float64).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from repro.core import autodiff as jautodiff
from repro.core import nn2sql as jnn
from repro.db.sql_engine import SQLEngine as JSQLEngine
from repro.db.train import train_in_db as j_train_in_db
from repro_torch.core import autodiff, nn2sql
from repro_torch.db import HAVE_DUCKDB, ConnectionPool, connect, relation_io
from repro_torch.db.adapters import HAVE_PSYCOPG2, PG_DSN_ENV
from repro_torch.db.sql_engine import SQLEngine
from repro_torch.db.train import train_in_db

RNG = np.random.RandomState(7)
ATOL = 1e-9

BACKENDS = ["sqlite"]
if HAVE_DUCKDB:  # pragma: no cover - only with the [db] extra
    BACKENDS.append("duckdb")
if HAVE_PSYCOPG2 and os.environ.get(PG_DSN_ENV):  # pragma: no cover - CI
    BACKENDS.append("postgres")


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


@pytest.fixture
def db_path(backend, tmp_path):
    """A path every pooled connection of the backend shares: a file for
    the embedded engines, the DSN default for postgres."""
    if backend == "sqlite":
        return str(tmp_path / "contract.sqlite")
    if backend == "duckdb":  # pragma: no cover - only with the [db] extra
        return str(tmp_path / "contract.duckdb")
    return ":memory:"  # postgres: resolves to REPRO_PG_DSN


@pytest.fixture
def adapter(backend, db_path):
    ad = connect(backend, db_path)
    yield ad
    ad.close()


# ---------------------------------------------------------------------------
# param style
# ---------------------------------------------------------------------------

class TestParamStyle:
    def test_flags_are_coherent(self, adapter):
        assert adapter.paramstyle in ("qmark", "format")
        expected = "?" if adapter.paramstyle == "qmark" else "%s"
        assert adapter.placeholder == expected
        assert adapter.supports_temp_tables is True
        assert isinstance(adapter.supports_python_udfs, bool)

    def test_bound_params_round_trip(self, adapter):
        ph = adapter.placeholder
        adapter.create_table("ct_kv", [("k", "integer"),
                                       ("v", "double precision"),
                                       ("s", "text")])
        adapter.bulk_insert("ct_kv", [(1, 0.5, "a"), (2, -3.25, "b%c"),
                                      (3, 2.0 ** -40, "100%")])
        rows = adapter.execute(
            f"select v, s from ct_kv where k = {ph}", (2,))
        assert rows == [(-3.25, "b%c")]
        rows = adapter.execute(
            f"select k from ct_kv where v > {ph} and v < {ph}",
            (0.0, 1.0))
        assert sorted(r[0] for r in rows) == [1, 3]

    def test_literal_percent_without_params(self, adapter):
        """Rendered plans legitimately contain ``%`` (modulo arithmetic);
        a format-style driver must not try to interpolate it when no
        parameters are bound."""
        rows = adapter.execute("select (7 % 3) + 0")
        assert int(rows[0][0]) == 1

    def test_executemany_binds_per_row(self, adapter):
        ph = adapter.placeholder
        adapter.create_table("ct_many", [("i", "integer"),
                                         ("v", "double precision")])
        before = adapter.counters["statements"]
        adapter.executemany(f"insert into ct_many values ({ph}, {ph})",
                            [(i, float(i) / 4) for i in range(10)])
        assert adapter.counters["statements"] == before + 1
        rows = adapter.execute("select count(*), sum(v) from ct_many")
        assert int(rows[0][0]) == 10
        assert float(rows[0][1]) == pytest.approx(sum(i / 4
                                                      for i in range(10)))


# ---------------------------------------------------------------------------
# temp-table shadowing
# ---------------------------------------------------------------------------

class TestTempTables:
    def test_temp_shadows_main_for_this_connection_only(self, backend,
                                                        db_path):
        pool = ConnectionPool(backend, db_path, size=2)
        try:
            a, b = pool[0], pool[1]
            a.create_table("ct_shadow", [("v", "double precision")])
            a.bulk_insert("ct_shadow", [(1.0,)])
            a.commit()
            assert b.execute("select v from ct_shadow") == [(1.0,)]
            # the temp twin shadows the name on A only
            a.create_table("ct_shadow", [("v", "double precision")],
                           temp=True)
            a.bulk_insert("ct_shadow", [(2.0,)])
            assert a.execute("select v from ct_shadow") == [(2.0,)]
            assert b.execute("select v from ct_shadow") == [(1.0,)]
            # re-creating the MAIN table through the contract un-shadows
            # cleanly (the shim drops the temp twin first)
            a.create_table("ct_shadow", [("v", "double precision")])
            a.bulk_insert("ct_shadow", [(3.0,)])
            assert a.execute("select v from ct_shadow") == [(3.0,)]
        finally:
            pool.close()

    def test_memory_pool_is_independent_per_worker_sqlite(self, tmp_path):
        """:memory: sqlite pools are N independent databases — the shard
        trainer's temp-leaf ingestion covers this by writing every leaf
        per connection."""
        pool = ConnectionPool("sqlite", ":memory:", size=2)
        try:
            pool[0].create_table("only_here", [("v", "integer")])
            with pytest.raises(Exception):
                pool[1].execute("select * from only_here")
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------

class TestConcurrentExecutemany:
    def test_threads_share_one_adapter_exactly(self, adapter):
        """N threads hammering ``bulk_insert`` on ONE adapter: the lock
        serializes raw access, the counters stay exact, every row lands."""
        adapter.create_table("ct_conc", [("t", "integer"),
                                         ("v", "double precision")])
        n_threads, per = 4, 200
        errs = []

        def work(t):
            try:
                adapter.bulk_insert(
                    "ct_conc", [(t, float(k)) for k in range(per)])
            except Exception as ex:  # pragma: no cover - the failure path
                errs.append(ex)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not errs
        rows = adapter.execute("select count(*) from ct_conc")
        assert int(rows[0][0]) == n_threads * per
        for t in range(n_threads):
            rows = adapter.execute(
                f"select count(*) from ct_conc where t = {adapter.placeholder}",
                (t,))
            assert int(rows[0][0]) == per


# ---------------------------------------------------------------------------
# generation registry (matrix-cache coherence)
# ---------------------------------------------------------------------------

class TestGenerationCounters:
    def test_sibling_write_flips_cache_stale(self, backend, db_path):
        pool = ConnectionPool(backend, db_path, size=2)
        try:
            a, b = pool[0], pool[1]
            m = RNG.randn(4, 3)
            relation_io.write_matrix(a, "ct_gen", m)
            a.commit()  # release the write txn before the sibling writes
            assert a.cache_fresh("ct_gen")
            relation_io.write_matrix(b, "ct_gen", m + 1)
            b.commit()
            assert not a.cache_fresh("ct_gen")
            assert b.cache_fresh("ct_gen")
        finally:
            pool.close()

    def test_temp_generations_key_per_adapter(self, backend, db_path):
        """A shard's temp-table churn must never invalidate a sibling's
        caches — temp generations live under a per-adapter key."""
        pool = ConnectionPool(backend, db_path, size=2)
        try:
            a, b = pool[0], pool[1]
            relation_io.write_matrix(b, "ct_tgen", RNG.randn(3, 3))
            b.commit()  # release the write txn — A writes only TEMP tables
            gen_b = b.table_gen("ct_tgen")
            assert b.cache_fresh("ct_tgen")
            for _ in range(3):  # A churns a TEMP table of the same name
                relation_io.write_matrix(a, "ct_tgen", RNG.randn(3, 3),
                                         temp=True)
            assert b.table_gen("ct_tgen") == gen_b
            assert b.cache_fresh("ct_tgen")
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# differential: the engine runs correctly on every backend
# ---------------------------------------------------------------------------

class TestBackendDifferential:
    def _graph_env(self):
        spec = (6, 5, 4, 3)
        env = {"img": RNG.randn(6, 5),
               "one_hot": np.eye(3)[RNG.randint(0, 3, 6)],
               "w_xh": RNG.randn(5, 4) * 0.3, "w_ho": RNG.randn(4, 3) * 0.3}
        return (nn2sql.build_graph(nn2sql.MLPSpec(*spec, lr=0.05)),
                jnn.build_graph(jnn.MLPSpec(*spec, lr=0.05)), env)

    def test_mlp_loss_and_grads_match_sqlite(self, backend, db_path):
        """The Algorithm-1 loss+gradient query, evaluated on the backend
        under test, against the sqlite baseline (itself pinned to the
        dense engine by tests/test_torch_db.py), and against the JAX
        package's query on sqlite."""
        g, jg, env = self._graph_env()
        grads = autodiff.gradients(g.loss, [g.w_xh, g.w_ho])
        roots = [g.loss, grads[g.w_xh], grads[g.w_ho]]
        jgrads = jautodiff.gradients(jg.loss, [jg.w_xh, jg.w_ho])
        jeng = JSQLEngine(plan_cache_=False)
        ref_eng = SQLEngine(plan_cache_=False)
        eng = SQLEngine(adapter=connect(backend, db_path),
                        plan_cache_=False)
        try:
            want = jeng.evaluate([jg.loss, jgrads[jg.w_xh], jgrads[jg.w_ho]],
                                 env)
            ref = ref_eng.evaluate(roots, env)
            got = eng.evaluate(roots, env)
            for r, o, w in zip(ref, got, want, strict=True):
                np.testing.assert_allclose(o, r, atol=ATOL)
                np.testing.assert_allclose(r, w, atol=ATOL)
        finally:
            eng.close()
            ref_eng.close()
            jeng.close()

    def test_train_in_db_matches_sqlite(self, backend, db_path):
        """Three stepped training iterations end-to-end on the backend
        (the strategy every backend supports) vs the sqlite run, and the
        sqlite run vs the JAX package's."""
        g, jg, env = self._graph_env()
        w = {"w_xh": env["w_xh"], "w_ho": env["w_ho"]}
        ref = train_in_db(g, w, env["img"], env["one_hot"], 3,
                          strategy="stepped", plan_cache_=False)
        got = train_in_db(g, w, env["img"], env["one_hot"], 3,
                          backend=backend, path=db_path,
                          strategy="stepped", plan_cache_=False)
        want = j_train_in_db(jg, w, env["img"], env["one_hot"], 3,
                             strategy="stepped", plan_cache_=False)
        for k in w:
            np.testing.assert_allclose(got.weights[k], ref.weights[k],
                                       atol=ATOL)
            np.testing.assert_allclose(ref.weights[k], want.weights[k],
                                       atol=ATOL)
