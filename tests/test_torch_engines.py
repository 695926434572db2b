"""The port's engines against the JAX package's dense engine on the same
seeded inputs: the paper's MLP (forward and Algorithm-1 value_and_grad),
seeded random DAGs, and the zoo tier (every node type, both directions).
Also Algorithm 1 against ``torch.autograd`` (the port's oracle in place of
``jax.grad``), the fused-layer rules of the dense engine, and the engines'
errors.

Tolerance: ``rtol=atol=1e-4``, the engine differentials' bound in the
reference (float32 on both sides, sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import autodiff as jad
from repro.core import dense as jdense
from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro_torch.core import Engine, autodiff, dense, rel_engine
from repro_torch.core import expr as E
from repro_torch.core import nn2sql
from repro_torch.core.autodiff import MapDeriv
from repro_torch.kernels import ops

TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ("dense", "relational")


def close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got, np.float64), np.asarray(want, np.float64),
        **TOL, err_msg=msg)


def mlp_env(rows=20, feats=4, hidden=6, classes=3, seed=0):
    r = np.random.RandomState(seed)
    env = {"img": r.rand(rows, feats).astype(np.float32),
           "one_hot": np.eye(classes, dtype=np.float32)[
               r.randint(0, classes, rows)]}
    spec = (rows, feats, hidden, classes)
    w = {k: np.asarray(v) for k, v in
         jnn.init_weights(jnn.MLPSpec(*spec)).items()}
    return spec, {**env, **w}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(20, 4, 6, 3), (64, 784, 20, 10)])
def test_mlp_forward_and_value_and_grad_match_jax_dense(kind, shape):
    spec, env = mlp_env(*shape)
    jg, tg = jnn.build_graph(jnn.MLPSpec(*spec)), nn2sql.build_graph(
        nn2sql.MLPSpec(*spec))
    jenv = {k: jnp.asarray(v) for k, v in env.items()}
    (jprobs,) = JEngine("dense").eval_fn([jg.a_ho])(jenv)
    eng = Engine(kind, device="cpu")
    (probs,) = eng.eval_fn([tg.a_ho])(env)
    close(probs, jprobs, "forward")
    jloss, jgrads = JEngine("dense").value_and_grad_fn(
        jg.loss, [jg.w_xh, jg.w_ho])(jenv)
    loss, grads = eng.value_and_grad_fn(tg.loss, [tg.w_xh, tg.w_ho])(env)
    close(loss, jloss, "loss")
    for name in ("w_xh", "w_ho"):
        close(grads[name], jgrads[name], name)


def test_algorithm1_matches_manual_equations_6_to_11():
    spec, env = mlp_env()
    g = nn2sql.build_graph(nn2sql.MLPSpec(*spec))
    tenv = {k: torch.from_numpy(v) for k, v in env.items()}
    alg = autodiff.gradients(g.loss, [g.w_xh, g.w_ho])
    man = nn2sql.manual_gradients(g)
    a = dense.evaluate([alg[g.w_xh], alg[g.w_ho]], tenv, "cpu")
    m = dense.evaluate([man[g.w_xh], man[g.w_ho]], tenv, "cpu")
    for x, y in zip(a, m):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


def test_sigmoid_layers_fuse_and_pre_activations_are_never_built(monkeypatch):
    """Map(SIGMOID, MatMul) runs as ops.fused_sigmoid_matmul, and
    sigmoid's derivative reads only the cached output, so z_xh and z_ho
    are never evaluated on the MLP path."""
    spec, env = mlp_env()
    g = nn2sql.build_graph(nn2sql.MLPSpec(*spec))
    seen, fused = [], []
    real_eval, real_fused = dense.eval_node, ops.fused_sigmoid_matmul

    def recording(node, ev, device):
        seen.append(node.name)
        return real_eval(node, ev, device)

    def counting(x, w):
        fused.append(x.shape)
        return real_fused(x, w)

    monkeypatch.setattr(dense, "eval_node", recording)
    monkeypatch.setattr(ops, "fused_sigmoid_matmul", counting)
    Engine("dense", device="cpu").value_and_grad_fn(
        g.loss, [g.w_xh, g.w_ho])(env)
    assert "z_xh" not in seen and "z_ho" not in seen
    assert "a_xh" in seen and "a_ho" in seen
    assert len(fused) == 2


def test_sigmoid_derivative_needs_no_input():
    fx = E.var("fx", (2, 3))
    node = MapDeriv(name="dsig", shape=(2, 3), fn=E.SIGMOID,
                    x=E.var("never_bound", (2, 3)), fx=fx)
    out = torch.tensor([[0.5, 0.25, 0.0], [1.0, 0.9, 0.1]])
    (got,) = dense.evaluate([node], {"fx": out}, "cpu")
    torch.testing.assert_close(got, out * (1 - out))


def random_dag(E_, seed, zoo):
    """A seeded DAG (the same in both packages) and its leaf values."""
    from test_torch_expr_autodiff import build_random_dag
    rng = np.random.RandomState(seed)
    root, leaves = build_random_dag(E_, rng, n_ops=8, zoo=zoo)
    vals = np.random.RandomState(seed + 1000)
    env = {k: (vals.randn(*s) * 0.5).astype(np.float32)
           for k, s in sorted(leaves.items())}
    return root, env


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("zoo", [False, True])
def test_random_dags_match_jax_dense(seed, zoo):
    jroot, env = random_dag(JE, seed, zoo)
    troot, _ = random_dag(E, seed, zoo)
    jenv = {k: jnp.asarray(v) for k, v in env.items()}
    (want,) = jdense.evaluate([jroot], jenv)
    jgrads = jad.derive(jroot, JE.const(1.0, jroot.shape))
    tgrads = autodiff.derive(troot, E.const(1.0, troot.shape))
    names = sorted(v.name for v in jgrads)
    jg = {v.name: g for v, g in jgrads.items()}
    tg = {v.name: g for v, g in tgrads.items()}
    gwant = jdense.evaluate([jg[n] for n in names], jenv)
    for kind in KINDS:
        eng = Engine(kind, device="cpu")
        (got,) = eng.eval_fn([troot])(env)
        close(got, want, f"{kind} forward")
        for n, g, w in zip(names, eng.eval_fn([tg[n] for n in names])(env),
                           gwant):
            close(g, w, f"{kind} d/d{n}")


def zoo_roots(E_):
    t, c = 5, 4
    x, idx = E_.var("x", (t, c)), E_.var("idx", (t, 1))
    a, b = E_.var("a", (t, c)), E_.var("b", (t, c))
    ma, mb = E_.var("ma", (t * 3, 3)), E_.var("mb", (t, 3))
    return [
        E_.row_reduce(x, "sum", 1), E_.row_reduce(x, "max", 1),
        E_.row_reduce(x, "sum", 0), E_.row_reduce(x, "max", 0),
        E_.softmax(x), E_.hadamard(E_.argtopk(x, 2), x),
        E_.gather(x, idx), E_.scatter(E_.gather(x, idx), idx, t),
        E_.row_shift(x, 1), E_.row_shift(x, -2), E_.row_shift(x, t + 1),
        E_.recurrence(a, b), E_.recurrence(a, b, reverse=True),
        E_.mat_recurrence(ma, mb), E_.mat_recurrence(ma, mb, True, False),
        E_.mat_recurrence(ma, mb, False, True),
        E_.mat_recurrence(ma, mb, True, True),
        E_.relu(x), E_.recip(E_.square(a) + b * 0.0 + E_.const(1.0, (t, c))),
    ]


def test_step_outer_matches_jax_dense():
    """StepOuter only appears inside MatRecurrence adjoints, which Algorithm
    1 never differentiates again; its forward value is compared here."""
    env = zoo_env()
    jx, jy = JE.var("a", (5, 4)), JE.var("mb", (5, 3))
    tx, ty = E.var("a", (5, 4)), E.var("mb", (5, 3))
    (want,) = jdense.evaluate([JE.step_outer(jx, jy)],
                              {k: jnp.asarray(v) for k, v in env.items()})
    for kind in KINDS:
        (got,) = Engine(kind, device="cpu").eval_fn([E.step_outer(tx, ty)])(env)
        close(got, want, kind)


def zoo_env():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(5, 4).astype(np.float32),
            "idx": np.array([[3], [0], [1], [1], [4]], np.float32),
            "a": (rng.rand(5, 4) * 0.5).astype(np.float32),
            "b": rng.randn(5, 4).astype(np.float32),
            "ma": (rng.randn(15, 3) * 0.4).astype(np.float32),
            "mb": rng.randn(5, 3).astype(np.float32)}


@pytest.mark.parametrize("kind", KINDS)
def test_zoo_tier_forward_and_gradients_match_jax_dense(kind):
    env = zoo_env()
    jenv = {k: jnp.asarray(v) for k, v in env.items()}
    eng = Engine(kind, device="cpu")
    for jr, tr in zip(zoo_roots(JE), zoo_roots(E)):
        what = type(tr).__name__
        (want,) = jdense.evaluate([jr], jenv)
        (got,) = eng.eval_fn([tr])(env)
        close(got, want, f"{what} forward")
        jgrads = jad.derive(jr, JE.const(1.0, jr.shape))
        tgrads = autodiff.derive(tr, E.const(1.0, tr.shape))
        names = sorted(v.name for v in jgrads if v.name != "idx")
        jg = {v.name: g for v, g in jgrads.items()}
        tg = {v.name: g for v, g in tgrads.items()}
        gwant = jdense.evaluate([jg[n] for n in names], jenv)
        for n, g, w in zip(names, eng.eval_fn([tg[n] for n in names])(env),
                           gwant):
            close(g, w, f"{what} d/d{n}")


def test_topk_ties_go_to_the_smaller_column():
    v = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    got = dense.topk_mask(torch.from_numpy(v), 2)
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 1, 0], [1, 1, 0, 0]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdense.topk_mask(jnp.asarray(v), 2)))


@pytest.mark.parametrize("offset", [-6, -2, 0, 1, 3, 5])
def test_row_shift_zero_fills(offset):
    x = np.arange(20, dtype=np.float32).reshape(5, 4)
    np.testing.assert_array_equal(
        dense.row_shift(torch.from_numpy(x), offset).numpy(),
        np.asarray(jdense.row_shift(jnp.asarray(x), offset)))


@pytest.mark.parametrize("kind", KINDS)
def test_algorithm1_matches_torch_autograd(kind):
    """torch.autograd is only the oracle: the graphs come from Algorithm 1."""
    env = zoo_env()
    for root in zoo_roots(E):
        grads = autodiff.derive(root, E.const(1.0, root.shape))
        names = sorted(v.name for v in grads if v.name != "idx")
        leaves = {k: torch.from_numpy(v).requires_grad_(k in names)
                  for k, v in env.items()}
        (out,) = dense.evaluate([root], leaves, "cpu")
        auto = torch.autograd.grad(out.sum(), [leaves[n] for n in names],
                                   allow_unused=True, materialize_grads=True) \
            if out.requires_grad else [torch.zeros_like(leaves[n])
                                       for n in names]   # shifted out of range
        mine = Engine(kind, device="cpu").eval_fn(
            [g for v, g in sorted(grads.items(), key=lambda p: p[0].name)
             if v.name in names])(env)
        for n, a, m in zip(names, auto, mine):
            torch.testing.assert_close(m, a, rtol=1e-4, atol=1e-5,
                                       msg=f"{type(root).__name__} d/d{n}")


def test_engine_errors():
    with pytest.raises(NotImplementedError):
        Engine("sql", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        Engine("columnar", device="cpu")
    x, idx = E.var("x", (3, 2)), E.var("idx", (2, 1))
    env = {"x": np.ones((3, 2), np.float32),
           "idx": np.array([[0], [3]], np.float32)}
    for kind in KINDS:
        with pytest.raises(ValueError, match="out of range"):
            Engine(kind, device="cpu").eval_fn([E.gather(x, idx)])(env)
    with pytest.raises(TypeError, match="RelTensor"):
        rel_engine.evaluate([x], {"x": torch.ones(3, 2)}, "cpu")


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine("dense")
    with pytest.raises(RuntimeError, match="CUDA"):
        nn2sql.init_weights(nn2sql.MLPSpec(4, 3, 2, 2))
