"""The port's IR and Algorithm 1 against the JAX package's: the same DAGs,
built in both packages, give gradient graphs with the same node types,
shapes, names and attributes in the same topological order — for the
paper's MLP, for the hand-derived Eqs. 6–11, and for seeded random DAGs in
the style of ``tests/test_property_dags.py`` (zoo tier included).

Auto-generated names carry a process-wide counter suffix that differs
between the two packages, so for auto-named nodes the prefix and the
auto-named flag are compared; given names must match exactly.
"""
import re

import numpy as np
import pytest

from repro.core import autodiff as jad
from repro.core import expr as JE
from repro.core import nn2sql as jnn
from repro_torch.core import autodiff as tad
from repro_torch.core import expr as TE
from repro_torch.core import nn2sql as tnn

PAIRS = ((JE, jad), (TE, tad))
_ATTRS = ("value", "c", "kind", "axis", "k", "offset", "reverse",
          "transposed")


def _signature(node, E, ad):
    name = re.sub(r"_\d+$", "", node.name) if E.is_auto_named(node) \
        else node.name
    attrs = tuple((a, getattr(node, a)) for a in _ATTRS if hasattr(node, a))
    fn = getattr(node, "fn", None)
    return (type(node).__name__, tuple(node.shape), name,
            E.is_auto_named(node), attrs, fn.name if fn else None,
            tuple(id(c) for c in node.children()))


def graph_signature(roots, E, ad):
    """Topological list of node signatures, children by topo position."""
    order = E.topo_order(*roots)
    pos = {id(n): i for i, n in enumerate(order)}
    sigs = []
    for n in order:
        s = _signature(n, E, ad)
        sigs.append(s[:-1] + (tuple(pos[c] for c in s[-1]),))
    return sigs


def grad_signature(grads: dict, wrt_names, E, ad):
    by_name = {v.name: g for v, g in grads.items()}
    return graph_signature([by_name[n] for n in wrt_names], E, ad)


def test_sql_renderings_are_byte_identical():
    for name, jfn in JE.MAP_FNS.items():
        assert TE.MAP_FNS[name].sql("v.v") == jfn.sql("v.v")
        assert TE.MAP_FNS[name].udf == jfn.udf


@pytest.mark.parametrize("rows,feats,hidden,classes",
                         [(12, 4, 6, 3), (256, 784, 20, 10)])
def test_mlp_gradient_graphs_match(rows, feats, hidden, classes):
    sigs = []
    for (E, ad), nn in zip(PAIRS, (jnn, tnn)):
        g = nn.build_graph(nn.MLPSpec(rows, feats, hidden, classes))
        grads = ad.gradients(g.loss, [g.w_xh, g.w_ho])
        sigs.append(grad_signature(grads, ["w_xh", "w_ho"], E, ad))
    assert sigs[0] == sigs[1]
    types = {s[0] for s in sigs[1]}
    assert {"MapDeriv", "MatMul", "Transpose", "Hadamard"} <= types


def test_manual_gradients_match():
    sigs = []
    for (E, ad), nn in zip(PAIRS, (jnn, tnn)):
        g = nn.build_graph(nn.MLPSpec(12, 4, 6, 3))
        sigs.append(grad_signature(nn.manual_gradients(g), ["w_xh", "w_ho"],
                                   E, ad))
    assert sigs[0] == sigs[1]


def build_random_dag(E, rng, n_ops: int, dims=(2, 3, 4), zoo=False):
    """Grow a DAG of matrix ops over leaves of compatible shapes; every
    choice comes from ``rng``, so two packages build the same DAG."""
    pick = lambda seq: seq[rng.randint(len(seq))]
    nodes, leaves = [], {}
    for i in range(rng.randint(2, 5)):
        shape = (pick(dims), pick(dims))
        nodes.append(E.var(f"x{i}", shape))
        leaves[f"x{i}"] = shape
    ops = ["matmul", "hadamard", "add", "sub", "sigmoid", "square",
           "transpose", "scale"]
    if zoo:
        ops += ["rsum", "rmax", "softmax", "shift", "recurrence", "relu"]
    for _ in range(n_ops):
        op, a = pick(ops), pick(nodes)
        if op == "matmul":
            compat = [n for n in nodes if n.shape[0] == a.shape[1]]
            if compat:
                nodes.append(E.matmul(a, pick(compat)))
        elif op in ("hadamard", "add", "sub", "recurrence"):
            compat = [n for n in nodes if n.shape == a.shape]
            if compat:
                nodes.append(getattr(E, op)(a, pick(compat)))
        elif op in ("sigmoid", "square", "transpose", "softmax", "relu"):
            nodes.append(getattr(E, op)(a))
        elif op == "scale":
            nodes.append(E.scale(float(rng.uniform(-2, 2)), a))
        elif op in ("rsum", "rmax"):
            nodes.append(E.row_reduce(a, op[1:], axis=int(rng.randint(2))))
        elif op == "shift":
            nodes.append(E.row_shift(a, int(rng.randint(-2, 3))))
    return nodes[-1], leaves


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("zoo", [False, True])
def test_random_dag_gradient_graphs_match(seed, zoo):
    sigs = []
    for E, ad in PAIRS:
        root, _ = build_random_dag(E, np.random.RandomState(seed),
                                   n_ops=8, zoo=zoo)
        grads = ad.derive(root, E.const(1.0, root.shape))
        names = sorted(v.name for v in grads)
        sigs.append((graph_signature([root], E, ad),
                     names, grad_signature(grads, names, E, ad)))
    assert sigs[0] == sigs[1]


def test_zoo_and_matrix_scan_gradient_graphs_match():
    """The nodes random DAGs rarely reach: Gather/Scatter/ArgTopK and the
    matrix-valued scan with its StepOuter adjoint."""
    sigs = []
    for E, ad in PAIRS:
        x, idx = E.var("x", (5, 4)), E.var("idx", (5, 1))
        a, b = E.var("a", (15, 3)), E.var("b", (5, 3))
        roots = [
            E.hadamard(E.gather(x, idx), E.argtopk(x, 2)),
            E.scatter(E.softmax(x), idx, 5),
            E.mat_recurrence(a, b), E.mat_recurrence(a, b, True, True),
        ]
        for r in roots:
            grads = ad.derive(r, E.const(1.0, r.shape))
            names = sorted(v.name for v in grads)
            sigs.append((graph_signature([r], E, ad),
                         grad_signature(grads, names, E, ad)))
    half = len(sigs) // 2
    assert sigs[:half] == sigs[half:]


def test_gradients_raise_when_nothing_flows():
    for E, ad in PAIRS:
        x, y = E.var("x", (2, 2)), E.var("y", (2, 2))
        with pytest.raises(ValueError, match="no gradient"):
            ad.gradients(E.square(x), [x, y])


def test_constructors_check_shapes_like_the_reference():
    for E, _ in PAIRS:
        with pytest.raises(ValueError):
            E.matmul(E.var("a", (2, 3)), E.var("b", (2, 3)))
        with pytest.raises(ValueError):
            E.argtopk(E.var("a", (2, 3)), 4)
        with pytest.raises(ValueError):
            E.mat_recurrence(E.var("a", (5, 3)), E.var("b", (5, 3)))
