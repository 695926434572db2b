"""Twins of ``tests/test_core_engines.py::TestRelTensor``: the port's
RelTensor against the JAX package's on the same seeded inputs (Listing 4's
building blocks, Listing 5's one-hot, the Fig. 5 byte model), plus the
relation's layout, which the CUDA kernel's sorted-segment precondition
relies on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import relational as JR
from repro_torch.core import relational as TR

TOL = dict(rtol=1e-5, atol=1e-6)     # the reference test's (one f32 sum)


def rnd(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def both_from_dense(a: np.ndarray):
    return (JR.RelTensor.from_dense(jnp.asarray(a)),
            TR.RelTensor.from_dense(torch.from_numpy(a)))


def same_relation(j, t, tol=None):
    """Same shape, same tuple order of (i, j), values within tol."""
    assert tuple(j.shape) == tuple(t.shape)
    np.testing.assert_array_equal(np.asarray(j.i), t.i.numpy())
    np.testing.assert_array_equal(np.asarray(j.j), t.j.numpy())
    if tol is None:
        np.testing.assert_array_equal(np.asarray(j.v), t.v.numpy())
    else:
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), **tol)


def test_roundtrip_and_layout():
    a = rnd(np.random.RandomState(0), 7, 5)
    jrel, trel = both_from_dense(a)
    same_relation(jrel, trel)
    assert trel.i.dtype == torch.int32 and trel.j.dtype == torch.int32
    np.testing.assert_array_equal(trel.to_dense().numpy(), a)
    assert trel.is_canonical()


@pytest.mark.parametrize("m,k,n", [(6, 9, 4), (2, 2, 2), (5, 3, 6), (1, 7, 3)])
def test_matmul(m, k, n):
    rng = np.random.RandomState(m * 100 + k * 10 + n)
    a, b = rnd(rng, m, k), rnd(rng, k, n)
    (ja, ta), (jb, tb) = both_from_dense(a), both_from_dense(b)
    same_relation(ja.matmul(jb), ta.matmul(tb), dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(ta.matmul(tb).to_dense().numpy(), a @ b,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m,n", [(5, 8), (3, 3), (1, 4)])
def test_transpose_is_index_rename_and_resort(m, n):
    a = rnd(np.random.RandomState(m + n), m, n)
    jrel, trel = both_from_dense(a)
    same_relation(jrel.transpose(), trel.transpose())
    np.testing.assert_array_equal(trel.transpose().to_dense().numpy(), a.T)
    np.testing.assert_array_equal(
        trel.transpose().transpose().to_dense().numpy(), a)
    # the re-sort keeps the rows non-decreasing: the kernel's precondition
    assert bool((trel.transpose().i.diff() >= 0).all())


def test_hadamard_add_sub_scale_map():
    rng = np.random.RandomState(1)
    a, b = rnd(rng, 4, 6), rnd(rng, 4, 6)
    (ja, ta), (jb, tb) = both_from_dense(a), both_from_dense(b)
    for op in ("hadamard", "add", "sub"):
        same_relation(getattr(ja, op)(jb), getattr(ta, op)(tb), TOL)
    same_relation(ja.scale(-1.5), ta.scale(-1.5), TOL)
    same_relation(ja.map(jax.nn.sigmoid), ta.map(torch.sigmoid), TOL)
    with pytest.raises(ValueError, match="aligned"):
        ta.hadamard(TR.RelTensor.from_dense(torch.ones(6, 4)))


def test_sparse_matmul_with_padding():
    """Padding tuples (i == m) must vanish like non-matching joins."""
    rng = np.random.RandomState(2)
    b = rnd(rng, 8, 5)
    rows = np.array([0, 0, 2, 3, 3, 3] + [4] * 4, np.int32)
    cols = np.array([1, 3, 0, 7, 2, 2] + [0] * 4, np.int32)
    vals = np.concatenate([rnd(rng, 6), np.ones(4, np.float32)])
    jrel = JR.RelTensor(i=jnp.asarray(rows), j=jnp.asarray(cols),
                        v=jnp.asarray(vals), shape=(4, 8))
    trel = TR.RelTensor(i=torch.from_numpy(rows), j=torch.from_numpy(cols),
                        v=torch.from_numpy(vals), shape=(4, 8))
    jb, tb = both_from_dense(b)
    got = trel.matmul(tb).to_dense().numpy()
    np.testing.assert_allclose(got, np.asarray(jrel.matmul(jb).to_dense()),
                               **TOL)
    expect = np.zeros((4, 5), np.float32)
    for r, c, v in zip(rows[:6], cols[:6], vals[:6]):
        expect[r] += v * b[c]
    np.testing.assert_allclose(got, expect, **TOL)
    # to_dense drops the padding tuples too
    np.testing.assert_array_equal(trel.to_dense().numpy(),
                                  np.asarray(jrel.to_dense()))


def test_matmul_rejects_bad_operands():
    a = TR.RelTensor.from_dense(torch.ones(2, 3))
    with pytest.raises(ValueError, match="matmul"):
        a.matmul(TR.RelTensor.from_dense(torch.ones(2, 3)))
    sparse = TR.one_hot(torch.tensor([0, 1, 2], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="canonical"):
        a.matmul(sparse)


def test_one_hot_matches_listing5():
    labels = np.array([0, 2, 1, 2], np.int32)
    jo = JR.one_hot(jnp.asarray(labels), 3)
    to = TR.one_hot(torch.from_numpy(labels), 3)
    same_relation(jo, to)
    np.testing.assert_array_equal(to.to_dense().numpy(),
                                  np.asarray(jax.nn.one_hot(labels, 3)))
    dense = TR.one_hot_dense(torch.from_numpy(labels), 3)
    assert dense.is_canonical()
    same_relation(JR.one_hot_dense(jnp.asarray(labels), 3), dense)
    same_relation(JR.features_to_relation(jnp.asarray(np.eye(3, 2,
                                                             dtype=np.float32))),
                  TR.features_to_relation(torch.eye(3, 2)))


def test_memory_model_fig5():
    """Fig. 5: relational storage = 3× array; join blow-up = 1000×
    tuples per entry for a 1000×1000 matmul."""
    assert TR.relation_bytes((1000, 1000)) == 3 * 1000 * 1000 * 8
    assert TR.join_intermediate_bytes(1000, 1000, 1000) == 1000 ** 3 * 24
    for shape in [(7, 5), (2000, 784)]:
        assert TR.relation_bytes(shape) == JR.relation_bytes(shape)
        assert TR.array_bytes(shape) == JR.array_bytes(shape)
    assert (TR.join_intermediate_bytes(2000, 784, 200)
            == JR.join_intermediate_bytes(2000, 784, 200))
    a = TR.RelTensor.from_dense(torch.ones(6, 9))
    b = TR.RelTensor.from_dense(torch.ones(9, 4))
    assert a.matmul_intermediate_tuples(b) == 6 * 9 * 4
