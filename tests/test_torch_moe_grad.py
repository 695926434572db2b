"""The gradient of the MoE layer's kernels in the port against JAX's.

The card route of ``kernels/ops.py`` runs here on the CPU: ``_on_host``
returns False, so ``relational_matmul``, ``moe_combine`` and
``moe_dispatch`` go through their autograd Functions
(``_RelationalMatmul``, ``_MoeDispatch``), and the kernels they launch
(``_relmm_cuda``, ``_moe_cuda``, ``_tuple_dot_cuda``, and the flash pair
for MLA's attention) are their plain versions, each call counted as its
wrapper counts a launch.  Four groups:

- the reduced DeepSeek-V2-Lite with ``impl="sort"``: the loss and every
  gradient leaf through the Functions against ``jax.value_and_grad`` of
  JAX's ``LM.loss_fn`` on the same numpy batch and converted weights, in
  float32 compute, with empty capacity slots and with most assignments
  dropped (JAX's ``mode="drop"``: a dropped assignment takes no gradient).
  Tolerance ``tests/test_torch_train.py``'s: the loss at rtol 1e-4, atol
  1e-5, the gradients at rtol 2e-4, atol 2e-5 (the atol in units of a
  leaf's largest entry where that exceeds 1);
- ``torch.autograd.gradcheck`` of each Function in float64;
- ``ref.tuple_dot`` against ``jnp`` in float32 and bf16 (rtol 1e-6 and
  atol 1e-6 in float32, both sum in float32 in another order; bf16 reads
  the same bf16 values, so the same bound holds);
- the launches a call and its backward make, and none under ``no_grad``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro.configs.base import get_config as jget_config
from repro.nn.model import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.nn.model import LM
from repro_torch.tree import leaves

F32 = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=2e-4, atol=2e-5)
ARCH = "deepseek_v2_lite_16b"
KERNELS = ("relmm", "moe", "tuple_dot", "flash", "flash_bwd")


@pytest.fixture
def card_route(monkeypatch):
    """ops' card route on CPU tensors, every kernel its plain version and
    each call counted by name."""
    calls = dict.fromkeys(KERNELS, 0)

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "_on_host", lambda *t: False)
    monkeypatch.setattr(ops, "_relmm_cuda",
                        counted("relmm", ref.relational_matmul))
    monkeypatch.setattr(ops, "_moe_cuda", counted("moe", ref.moe_dispatch))
    monkeypatch.setattr(ops, "_tuple_dot_cuda",
                        counted("tuple_dot", ref.tuple_dot))
    monkeypatch.setattr(ops, "_flash_cuda",
                        counted("flash", ref.flash_attention))
    monkeypatch.setattr(ops, "_flash_bwd_cuda",
                        counted("flash_bwd", ref.flash_attention_bwd))
    monkeypatch.setattr(ops, "_flash_takes", lambda t: t.stride(-1) == 1)
    return calls


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


@functools.lru_cache(maxsize=None)
def jax_params():
    return jax.jit(JLM(jget_config(ARCH, reduced=True)).init)(
        jax.random.PRNGKey(0))


def models(capacity_factor):
    moe = dataclasses.replace(get_config(ARCH, reduced=True).moe,
                              impl="sort", capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), moe=moe)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), moe=moe)
    return (JLM(jcfg), LM(cfg, device="cpu"),
            convert.from_jax_params(jax_params(), device="cpu"))


def routing_counts(lm, params, tokens, monkeypatch):
    """(empty slots, dropped assignments) over the MoE layers of one
    forward, from the routing the port computes."""
    from repro_torch.nn import moe as M
    seen = []
    route = M._route

    def logged(p, x, cfg):
        gates, idx, aux = route(p, x, cfg)
        cap = M._capacity(x.shape[-2], cfg)
        counts = torch.nn.functional.one_hot(
            idx.reshape(idx.shape[0], -1), cfg.n_experts).sum(1)
        seen.append((int((cap - counts).clamp(min=0).sum()),
                     int((counts - cap).clamp(min=0).sum())))
        return gates, idx, aux

    with monkeypatch.context() as m:
        m.setattr(M, "_route", logged)
        with torch.no_grad():
            lm.forward(params, {"tokens": tokens})
    return [sum(c) for c in zip(*seen)]


@pytest.mark.parametrize("capacity_factor,seq", [(1.25, 12), (0.05, 64)],
                         ids=["empty_slots", "many_drops"])
def test_moe_sort_trains_like_jax_through_the_functions(
        card_route, f32_compute, monkeypatch, capacity_factor, seq):
    """Loss, ce, aux and every gradient leaf.  ``empty_slots``: 24 tokens
    into 8 experts of 8 slots (the capacity's floor), about a quarter of
    the slots empty; ``many_drops``: 128 tokens a group, top-2, into 64
    slots, so at least three quarters of the assignments drop."""
    jlm, lm, params = models(capacity_factor)
    rng = np.random.RandomState(seq)
    tokens, labels = (rng.randint(0, lm.cfg.vocab, (2, seq)).astype(np.int32)
                      for _ in range(2))
    empty, dropped = routing_counts(lm, params, torch.from_numpy(tokens),
                                    monkeypatch)
    n_moe = lm.cfg.n_layers - lm.cfg.moe.first_k_dense
    assignments = n_moe * 2 * seq * lm.cfg.moe.top_k
    if capacity_factor < 1:
        assert dropped >= 0.75 * assignments
    else:
        assert empty > 0
    for k in card_route:
        card_route[k] = 0
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jlm.loss_fn, has_aux=True))(jax_params(), jb)
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, metrics = lm.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                        "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   **F32)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, j in zip(names, grads, jax.tree.leaves(jgrads),
                          strict=True):
        j = np.asarray(j, np.float32)
        g = np.zeros(j.shape, np.float32) if g is None else g.numpy()
        tol = dict(STEP, atol=STEP["atol"] * max(1.0, float(np.abs(j).max())))
        np.testing.assert_allclose(g, j, err_msg=name, **tol)
    # remat="full": each layer's forward twice (the recompute), one backward
    layers = lm.cfg.n_layers
    assert card_route == dict(
        relmm=4 * n_moe, moe=2 * n_moe, tuple_dot=n_moe,
        flash=2 * layers, flash_bwd=layers)


def relation(rng, m, k, nnz, pad, sort_rows=True):
    """A relation of ``nnz`` tuples on rows 0..m-1 (sorted, or in random
    order), ``pad`` padding tuples (row m) last, its col ids in random
    order with repeats, and some values 0."""
    rows = rng.randint(0, m, nnz)
    rows = np.sort(rows) if sort_rows else rows
    rows = np.concatenate([rows, np.full(pad, m)]).astype(np.int32)
    cols = rng.randint(0, k, nnz + pad).astype(np.int32)
    vals = rng.randn(nnz + pad) * (rng.rand(nnz + pad) > 0.2)
    return torch.from_numpy(rows), torch.from_numpy(cols), torch.tensor(vals)


@pytest.mark.parametrize("sort_rows", [True, False])
def test_relational_matmul_function_gradcheck(card_route, sort_rows):
    """d vals and d b of ``_RelationalMatmul`` in float64, with padding
    tuples, zero values and unsorted col ids (and rows, the second
    case)."""
    rng = np.random.RandomState(3)
    rows, cols, vals = relation(rng, 5, 7, 24, 4, sort_rows)
    b = torch.tensor(rng.randn(7, 6))
    torch.autograd.gradcheck(
        lambda v, b: ops._RelationalMatmul.apply(rows, cols, v, b, 5),
        (vals.requires_grad_(), b.requires_grad_()))


def test_moe_dispatch_function_gradcheck(card_route):
    """d x and d gates of ``_MoeDispatch`` in float64, with repeated
    indices and zero gates (the empty slots: token 0, gate 0)."""
    rng = np.random.RandomState(4)
    idx = torch.tensor(np.r_[rng.randint(0, 6, 10), [2, 2, 0, 0]],
                       dtype=torch.int32)
    gates = torch.tensor(np.r_[rng.rand(10), [0.5, 0.25, 0.0, 0.0]])
    x = torch.tensor(rng.randn(6, 8))
    torch.autograd.gradcheck(
        lambda x, g: ops._MoeDispatch.apply(x, idx, g),
        (x.requires_grad_(), gates.requires_grad_()))


def test_moe_combine_gradient(card_route):
    """``moe_combine`` on the card route is ``_RelationalMatmul`` with unit
    values: its gradient is autograd's of the plain combine, and only the
    product over the transposed relation runs in the backward."""
    rng = np.random.RandomState(5)
    rows = torch.tensor(np.r_[np.sort(rng.randint(0, 4, 12)), [4, 4]],
                        dtype=torch.int32)
    y = torch.tensor(rng.randn(14, 8), dtype=torch.float32,
                     requires_grad=True)
    dout = torch.tensor(rng.randn(4, 8), dtype=torch.float32)
    got = torch.autograd.grad(ops.moe_combine(y, rows, 4), y, dout)[0]
    y_plain = y.detach().clone().requires_grad_()
    want = torch.autograd.grad(ref.moe_combine(y_plain, rows, 4), y_plain,
                               dout)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert card_route["relmm"] == 2 and card_route["tuple_dot"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_tuple_dot_matches_jnp(dtype):
    """out[t] = a[rows[t]] · b[cols[t]] with a float32 and b in ``dtype``,
    padding rows (row == a's row count) 0, against the same sum in jnp."""
    rng = np.random.RandomState(6)
    ma, mb, d, nnz = 9, 11, 40, 30
    a = rng.randn(ma, d).astype(np.float32)
    b = torch.tensor(rng.randn(mb, d), dtype=torch.float32).to(dtype)
    rows = np.r_[rng.randint(0, ma, nnz - 3), [ma] * 3].astype(np.int32)
    cols = rng.randint(0, mb, nnz).astype(np.int32)
    got = ref.tuple_dot(torch.from_numpy(a), torch.from_numpy(rows), b,
                        torch.from_numpy(cols))
    assert got.dtype == torch.float32
    jb = jnp.asarray(b.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    live = rows < ma
    want = jnp.where(live, jnp.sum(
        jnp.asarray(a)[np.where(live, rows, 0)]
        * jb[cols].astype(jnp.float32), axis=-1), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got[-3:] == 0).all()


def test_plain_tuple_dot_keeps_float64():
    rng = np.random.RandomState(7)
    a, b = torch.tensor(rng.randn(3, 8)), torch.tensor(rng.randn(4, 8))
    rows = torch.tensor([0, 2, 3], dtype=torch.int32)
    cols = torch.tensor([1, 3, 0], dtype=torch.int32)
    got = ref.tuple_dot(a, rows, b, cols)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got[:2], (a[[0, 2]] * b[[1, 3]]).sum(-1),
                               rtol=1e-15, atol=1e-15)
    assert got[2] == 0


@pytest.mark.parametrize("needs", ["both", "dense", "values"])
def test_relational_matmul_launches(card_route, needs):
    """One forward launch; in the backward the product over the transposed
    relation for d b and one tuple_dot for d vals, each only where its
    operand requires grad; nothing is recorded under no_grad."""
    rng = np.random.RandomState(8)
    rows, cols, vals = relation(rng, 6, 5, 20, 3)
    vals, b = vals.float(), torch.tensor(rng.randn(5, 16),
                                         dtype=torch.float32)
    vals.requires_grad_(needs in ("both", "values"))
    b.requires_grad_(needs in ("both", "dense"))
    out = ops.relational_matmul(rows, cols, vals, b, 6)
    assert card_route["relmm"] == 1 and out.grad_fn is not None
    out.backward(torch.ones_like(out))
    assert card_route["relmm"] == 1 + (needs != "values")
    assert card_route["tuple_dot"] == int(needs != "dense")
    with torch.no_grad():
        out = ops.relational_matmul(rows, cols, vals, b, 6)
    assert out.grad_fn is None and card_route["relmm"] == 2 + (
        needs != "values")


@pytest.mark.parametrize("needs", ["both", "x", "gates"])
def test_moe_dispatch_launches(card_route, needs):
    rng = np.random.RandomState(9)
    idx = torch.tensor(rng.randint(0, 4, 10), dtype=torch.int32)
    x = torch.tensor(rng.randn(4, 16), dtype=torch.float32,
                     requires_grad=needs in ("both", "x"))
    gates = torch.tensor(rng.rand(10), dtype=torch.float32,
                         requires_grad=needs in ("both", "gates"))
    out = ops.moe_dispatch(x, idx, gates)
    assert card_route["moe"] == 1 and out.grad_fn is not None
    out.backward(torch.ones_like(out))
    assert card_route["relmm"] == int(needs != "gates")
    assert card_route["tuple_dot"] == int(needs != "x")
    with torch.no_grad():
        assert ops.moe_dispatch(x, idx, gates).grad_fn is None
    assert card_route["moe"] == 2 and card_route["relmm"] == int(
        needs != "gates")


def test_dispatch_gradient_uses_the_rounded_gate(card_route):
    """With bf16 x the forward scales by the gate rounded to bf16, so d x
    sums dOut times that rounded gate (in float32, rounded once to bf16);
    d gates is dOut · x summed in float32."""
    rng = np.random.RandomState(10)
    idx = torch.tensor([0, 1, 0, 2, 1, 0], dtype=torch.int32)
    gates = torch.tensor(rng.rand(6), dtype=torch.float32, requires_grad=True)
    x = torch.tensor(rng.randn(3, 8), dtype=torch.float32).to(
        torch.bfloat16).requires_grad_()
    dout = torch.tensor(rng.randn(6, 8), dtype=torch.float32).to(
        torch.bfloat16)
    dx, dg = torch.autograd.grad(ops.moe_dispatch(x, idx, gates),
                                 (x, gates), dout)
    g16 = gates.detach().to(torch.bfloat16).float()
    want = torch.zeros(3, 8).index_add_(0, idx.long(),
                                        dout.float() * g16[:, None])
    assert dx.dtype == torch.bfloat16 and dg.dtype == torch.float32
    torch.testing.assert_close(dx, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(
        dg, (dout.float() * x.detach().float()[idx.long()]).sum(-1),
        rtol=1e-6, atol=1e-6)
