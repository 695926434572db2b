"""Property tests of the port's relation pivots (``repro_torch.db.relation_io``)
against the JAX package's: dense ↔ rows/columns ↔ RelTensor, 1-based
indices at the database boundary, gaps coalescing to 0, and ingestion
through a live sqlite connection.

Tolerance: none.  The pivots move float64 values without arithmetic, and
a float32 value survives float64 exactly, so every round trip is exact.
This includes float32 subnormals, which the reference's twin
(``tests/test_relation_io_property.py::TestRelTensorRoundTrip``) loses to
XLA's flush to zero on the CPU; the port's RelTensor keeps them, so its
twin holds that test's assertion as written.
"""
import numpy as np
import pytest
import torch

import hypothesis.strategies as st
from hypothesis import example, given, settings

from repro.db import relation_io as jrio
from repro_torch.core.relational import RelTensor
from repro_torch.db import SQLiteAdapter, connect, relation_io
from repro_torch.db import adapter as adapter_mod
from repro_torch.db.dialect import json_to_matrix, matrix_to_json

shapes = st.tuples(st.integers(1, 8), st.integers(1, 8))
finite = st.floats(-1e6, 1e6, allow_nan=False, allow_infinity=False,
                   width=32)


@st.composite
def matrices(draw):
    r, c = draw(shapes)
    vals = draw(st.lists(finite, min_size=r * c, max_size=r * c))
    return np.asarray(vals, dtype=np.float64).reshape(r, c)


@st.composite
def sparse_rows(draw):
    """Unique 1-based (i, j) cells with gaps, any order."""
    r, c = draw(shapes)
    cells = draw(st.lists(st.tuples(st.integers(1, r), st.integers(1, c)),
                          unique=True, max_size=r * c))
    vals = draw(st.lists(finite, min_size=len(cells), max_size=len(cells)))
    return [(i, j, v) for (i, j), v in zip(cells, vals)], (r, c)


@settings(max_examples=50, deadline=None)
@given(matrices())
def test_dense_rows_dense_and_the_reference_pivots(a):
    rows = relation_io.matrix_to_rows(a)
    assert rows == jrio.matrix_to_rows(a) == relation_io.matrix_to_rows_percell(a)
    assert rows[0][:2] == (1, 1) and rows[-1][:2] == a.shape
    assert [r[:2] for r in rows] == sorted(r[:2] for r in rows)
    np.testing.assert_array_equal(relation_io.rows_to_matrix(rows, a.shape), a)
    i, j, v = relation_io.matrix_to_columns(torch.from_numpy(a))
    assert relation_io.columns_to_rows(i, j, v) == rows


@settings(max_examples=50, deadline=None)
@given(sparse_rows())
def test_gaps_coalesce_to_zero_in_any_order(rows_shape):
    rows, shape = rows_shape
    m = relation_io.rows_to_matrix(rows, shape)
    np.testing.assert_array_equal(m, jrio.rows_to_matrix(rows, shape))
    np.testing.assert_array_equal(
        m, relation_io.rows_to_matrix(rows[::-1], shape))
    filled = {(i - 1, j - 1): v for i, j, v in rows}
    for (i, j), v in filled.items():
        assert m[i, j] == v
    assert np.count_nonzero(m) <= len(filled)


@settings(max_examples=25, deadline=None)
@given(matrices())
@example(np.array([[4.27129785e-41]]))
def test_reltensor_rows_reltensor(a):
    """The exact round trip the reference's twin asserts; the example is
    the float32 subnormal on which XLA's CPU flush loses it."""
    a32 = a.astype(np.float32)
    rt = RelTensor.from_dense(torch.from_numpy(a32))
    back = relation_io.rows_to_reltensor(relation_io.reltensor_to_rows(rt),
                                         rt.shape, device="cpu")
    assert back.v.dtype == torch.float32 and back.v.device.type == "cpu"
    np.testing.assert_array_equal(back.to_dense().numpy(), a32)


def test_padding_rows_dropped():
    rt = RelTensor(i=torch.tensor([0, 2], dtype=torch.int32),
                   j=torch.tensor([1, 0], dtype=torch.int32),
                   v=torch.tensor([3.0, 0.0]), shape=(2, 2))
    assert relation_io.reltensor_to_rows(rt) == [(1, 2, 3.0)]


def test_read_reltensor_defaults_to_the_card():
    with connect("sqlite") as ad:
        relation_io.write_matrix(ad, "m", np.eye(2))
        rt = relation_io.read_reltensor(ad, "m", (2, 2), device="cpu")
        np.testing.assert_array_equal(rt.to_dense().numpy(), np.eye(2))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                relation_io.read_reltensor(ad, "m", (2, 2))


@settings(max_examples=20, deadline=None)
@given(matrices())
def test_write_reltensor_read_reltensor_bit_for_bit(a):
    """The boundary phase 9 (c) of ``chip_smoke.py`` checks on the card."""
    a32 = a.astype(np.float32)
    with connect("sqlite") as ad:
        relation_io.write_reltensor(
            ad, "w", RelTensor.from_dense(torch.from_numpy(a32)))
        back = relation_io.read_reltensor(ad, "w", a.shape, device="cpu")
    assert torch.equal(back.to_dense(), torch.from_numpy(a32))


@settings(max_examples=20, deadline=None)
@given(matrices())
def test_write_read_through_sqlite(a):
    with connect("sqlite") as ad:
        relation_io.write_matrix(ad, "m", a)
        np.testing.assert_array_equal(
            relation_io.read_matrix(ad, "m", a.shape), a)
        relation_io.write_matrix_percell(ad, "base", a)
        relation_io.write_matrix_array(ad, "arr", torch.from_numpy(a))
        np.testing.assert_array_equal(
            relation_io.read_matrix_array(ad, "arr"), a)
        np.testing.assert_array_equal(
            relation_io.read_matrix(ad, "base", a.shape), a)


@settings(max_examples=50, deadline=None)
@given(matrices())
def test_json_codec_roundtrip_exact(a):
    back = json_to_matrix(matrix_to_json(a))
    assert back.shape == a.shape
    np.testing.assert_array_equal(back, a)


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_array_udfs_in_engine(data):
    """``mt`` is an involution and ``mm`` matches numpy, as sqlite runs
    the port's UDFs."""
    small = st.floats(-8, 8, allow_nan=False, width=32)
    r, k, c = (data.draw(st.integers(1, 5)) for _ in range(3))
    draw_m = lambda rr, cc: np.asarray(
        data.draw(st.lists(small, min_size=rr * cc, max_size=rr * cc)),
        dtype=np.float64).reshape(rr, cc)
    a, b = draw_m(r, k), draw_m(k, c)
    with connect("sqlite") as ad:
        (tt,), = ad.execute("select mt(mt(?))", (matrix_to_json(a),))
        (ab,), = ad.execute("select mm(?, ?)",
                            (matrix_to_json(a), matrix_to_json(b)))
    np.testing.assert_array_equal(json_to_matrix(tt), a)
    np.testing.assert_allclose(json_to_matrix(ab), a @ b, rtol=1e-12,
                               atol=1e-9)


def test_chunked_executemany_boundaries(monkeypatch):
    a = np.arange(42, dtype=np.float64).reshape(6, 7)
    monkeypatch.setattr(adapter_mod, "CHUNK_ROWS", 10)
    monkeypatch.setattr(adapter_mod.SQLiteAdapter, "ROWS_PER_STMT", 5)
    with connect("sqlite") as ad:
        ad.sqlite_version = (3, 34, 1)        # the VALUES path
        relation_io.write_matrix(ad, "m", a)
        np.testing.assert_array_equal(
            relation_io.read_matrix(ad, "m", a.shape), a)
        ad.create_table("g", relation_io.MATRIX_COLUMNS)
        adapter_mod.Adapter.insert_columns(
            ad, "g", relation_io.matrix_to_columns(a))
        np.testing.assert_array_equal(
            relation_io.read_matrix(ad, "g", a.shape), a)


def test_non_matrix_rejected():
    with pytest.raises(ValueError):
        relation_io.matrix_to_columns(np.ones((2, 2, 2)))
    with pytest.raises(ValueError):
        relation_io.matrix_to_rows_percell(np.ones(3))


@pytest.mark.parametrize("version", [(3, 34, 1), (3, 40, 1)])
def test_ingest_path_follows_the_sqlite_version(version):
    """VALUES below 3.38 (exact, keeps a diff base), ``json_each`` from
    3.38 (no diff base: its text→real parse may move a value by an ulp)."""
    a = np.random.RandomState(0).randn(3, 4)
    with connect("sqlite") as ad:
        ad.sqlite_version = version
        relation_io.write_matrix(ad, "w", a)
        np.testing.assert_allclose(relation_io.read_matrix(ad, "w", (3, 4)),
                                   a, rtol=1e-15, atol=0)
        assert ("w" in ad.matrix_cache) == (version < (3, 38))
        m = a.copy()
        m[1, 2] = 7.0
        written = relation_io.update_matrix_delta(ad, "w", m)
        assert written == (8 if version < (3, 38) else m.nbytes)
        np.testing.assert_allclose(relation_io.read_matrix(ad, "w", (3, 4)),
                                   m, rtol=1e-15, atol=0)


def test_two_connection_stale_matrix_cache(tmp_path):
    """Twin of ``tests/test_serving_db.py::TestPoolBugfixes::
    test_two_connection_stale_matrix_cache``: adapter A's diff base goes
    stale when sibling B rewrites the relation, and A's next delta update
    must fall back to a full write instead of patching B's content.  The
    VALUES ingest is forced on A (a sqlite below 3.38), the path that
    keeps a diff base; from 3.38 on ``write_matrix`` ingests through
    ``json_each`` and keeps none, so the guard is never reached."""
    db = str(tmp_path / "shared.db")
    a, b = SQLiteAdapter(db), SQLiteAdapter(db)
    a.sqlite_version = (3, 34, 1)
    m0 = np.arange(12, dtype=np.float64).reshape(3, 4)
    relation_io.write_matrix(a, "w", m0)      # A keeps m0 as its diff base
    a.commit()
    assert "w" in a.matrix_cache
    relation_io.write_matrix(b, "w", m0 + 100.0)   # sibling rewrite
    b.commit()
    m2 = m0.copy()
    m2[0, 0] = -5.0
    assert relation_io.update_matrix_delta(a, "w", m2) is None
    relation_io.write_matrix(a, "w", m2)    # the caller's fallback
    a.commit()
    assert np.array_equal(relation_io.read_matrix(b, "w", (3, 4)), m2)
    a.close()
    b.close()
