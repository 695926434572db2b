"""Twins of ``tests/test_system.py`` for the port: the paper's pipeline
(§4.1 data transform → Algorithm-1 training in a recursive CTE → §4.3
accuracy) run by ``repro_torch`` on the CPU beside the JAX package, with
the data and the initial weights carried across as numpy arrays
(``convert.from_jax_params``), so both compute from the same numbers.

Tolerances: weights after 25 Iris steps ``rtol=1e-4, atol=1e-5`` (the
reference's engine-agreement bound: float32 on both sides, sums in another
order); the MNIST-shaped run sums over 784 features and 256 rows, so it is
held at ``rtol=atol=1e-4``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.core import Engine as JEngine
from repro.core import history_bytes as j_history_bytes
from repro.core import nn2sql as jnn
from repro.core import recursive_cte_py as j_recursive_cte_py
from repro.core.relational import one_hot_dense as j_one_hot_dense
from repro_torch import convert, data
from repro_torch.core import Engine, history_bytes, nn2sql, recursive_cte_py
from repro_torch.core.relational import one_hot_dense

KINDS = ("dense", "relational")
IRIS_TOL = dict(rtol=1e-4, atol=1e-5)


def test_data_and_initial_weights_are_bit_identical():
    for (jx, jy), (tx, ty) in [
            (jdata.make_iris(), data.make_iris(device="cpu")),
            (jdata.make_mnist_like(64, seed=3),
             data.make_mnist_like(64, seed=3, device="cpu"))]:
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    spec = (150, 4, 8, 3)
    jw = jnn.init_weights(jnn.MLPSpec(*spec))
    tw = nn2sql.init_weights(nn2sql.MLPSpec(*spec), device="cpu")
    for k in ("w_xh", "w_ho"):
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    rx, ry = data.replicate(*data.make_iris(device="cpu"), 3)
    jrx, jry = jdata.replicate(*jdata.make_iris(), 3)
    np.testing.assert_array_equal(rx.numpy(), np.asarray(jrx))
    np.testing.assert_array_equal(ry.numpy(), np.asarray(jry))


def test_one_hot_labels_is_jax_one_hot():
    """Equal to ``jax.nn.one_hot``, including the zero rows it gives labels
    outside 0..C-1, negative ones too."""
    y = np.array([0, 2, 1, 9, 3, 3, 10, -1, 11, -7, 2 ** 31 - 1], np.int32)
    got = data.one_hot_labels(torch.from_numpy(y), 10, device="cpu")
    want = np.asarray(jdata.one_hot_labels(jnp.asarray(y), 10))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[6:].any()


def test_convert_round_trip():
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": jnp.asarray([1.5, -2.0], jnp.bfloat16)}
    got = convert.from_jax_params(params, device="cpu")
    assert got["w"].dtype == torch.float32 and got["b"].dtype == torch.bfloat16
    back = convert.to_numpy(got)
    np.testing.assert_array_equal(back["w"], params["w"])
    np.testing.assert_array_equal(back["b"], np.asarray(params["b"],
                                                        np.float32))


def _iris(n_hidden, lr=0.01):
    jx, jy = jdata.make_iris()
    spec = (150, 4, n_hidden, 3)
    jw0 = jnn.init_weights(jnn.MLPSpec(*spec, lr=lr))
    jy_oh = j_one_hot_dense(jy, 3).to_dense()
    t = convert.from_jax_params({"x": jx, "y": jy, "y_oh": jy_oh},
                                device="cpu")
    return spec, (jx, jy, jy_oh, jw0), t, convert.from_jax_params(
        jw0, device="cpu")


def test_iris_25_steps_match_jax_on_both_engines():
    spec, (jx, _, jy_oh, jw0), t, w0 = _iris(8)
    jg = jnn.build_graph(jnn.MLPSpec(*spec))
    want, _ = jnn.train(jg, jw0, jx, jy_oh, 25, JEngine("dense"))
    g = nn2sql.build_graph(nn2sql.MLPSpec(*spec))
    for kind in KINDS:
        got, _ = nn2sql.train(g, w0, t["x"], t["y_oh"], 25,
                              Engine(kind, device="cpu"))
        for k in ("w_xh", "w_ho"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **IRIS_TOL, err_msg=f"{kind} {k}")


@pytest.mark.parametrize("kind,n_iters,floor", [("dense", 300, 0.9),
                                                ("relational", 150, 0.85)])
def test_training_learns_iris(kind, n_iters, floor):
    x, y = data.make_iris(device="cpu")
    spec = nn2sql.MLPSpec(150, 4, 20, 3, lr=0.05)
    g = nn2sql.build_graph(spec)
    eng = Engine(kind, device="cpu")
    y_oh = one_hot_dense(y, 3).to_dense()
    wf, _ = nn2sql.train(g, nn2sql.init_weights(spec, device="cpu"), x, y_oh,
                         n_iters, eng)
    acc = float(nn2sql.accuracy(nn2sql.infer(g, eng)(wf, x), y))
    assert acc >= floor, acc


def test_union_all_history_matches_jax():
    """§8: every weight version stays materialised, base row included."""
    spec, (jx, _, jy_oh, jw0), t, w0 = _iris(8)
    _, jhist = jnn.train(jnn.build_graph(jnn.MLPSpec(*spec)), jw0, jx, jy_oh,
                         10, JEngine("dense"), materialize_history=True)
    _, hist = nn2sql.train(nn2sql.build_graph(nn2sql.MLPSpec(*spec)), w0,
                           t["x"], t["y_oh"], 10, Engine("dense", device="cpu"),
                           materialize_history=True)
    assert tuple(hist["w_xh"].shape) == (11, 4, 8)
    np.testing.assert_array_equal(hist["w_xh"][0].numpy(), np.asarray(jw0["w_xh"]))
    assert not torch.allclose(hist["w_xh"][0], hist["w_xh"][-1])
    np.testing.assert_allclose(hist["w_ho"].numpy(), np.asarray(jhist["w_ho"]),
                               **IRIS_TOL)
    assert history_bytes(w0, 10) == j_history_bytes(jw0, 10)


def test_recursive_cte_py_keeps_the_base_row():
    step = lambda s, it: {"w": s["w"] * 2 + it}
    final, hist = recursive_cte_py({"w": torch.ones(2)}, step, 3,
                                   materialize_history=True)
    jfinal, jhist = j_recursive_cte_py({"w": jnp.ones(2)}, step, 3,
                                       materialize_history=True)
    assert len(hist) == len(jhist) == 4
    np.testing.assert_array_equal(final["w"].numpy(), np.asarray(jfinal["w"]))
    assert recursive_cte_py({"w": torch.ones(2)}, step, 3)[1] is None


def test_mnist_shape_pipeline_matches_jax():
    """The paper's second benchmark shape: 784 features, 10 classes."""
    jx, jy = jdata.make_mnist_like(256)
    spec = (256, 784, 20, 10)
    jspec = jnn.MLPSpec(*spec, lr=0.05)
    jw0 = jnn.init_weights(jspec)
    jy_oh = jdata.one_hot_labels(jy, 10)
    jg = jnn.build_graph(jspec)
    want, _ = jnn.train(jg, jw0, jx, jy_oh, 5, JEngine("dense"))
    jprobs = jnn.infer(jg, JEngine("dense"))(want, jx)

    x, y = data.make_mnist_like(256, device="cpu")
    g = nn2sql.build_graph(nn2sql.MLPSpec(*spec, lr=0.05))
    y_oh = data.one_hot_labels(y, 10, device="cpu")
    w0 = convert.from_jax_params(jw0, device="cpu")
    for kind in KINDS:
        eng = Engine(kind, device="cpu")
        wf, _ = nn2sql.train(g, w0, x, y_oh, 5, eng)
        probs = nn2sql.infer(g, eng)(wf, x)
        assert probs.shape == (256, 10) and bool(torch.isfinite(probs).all())
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   rtol=1e-4, atol=1e-4, err_msg=kind)
        for k in ("w_xh", "w_ho"):
            np.testing.assert_allclose(convert.to_numpy(wf)[k],
                                       np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{kind} {k}")
        assert float(nn2sql.accuracy(probs, y)) == pytest.approx(
            float(jnn.accuracy(jprobs, jy)))
