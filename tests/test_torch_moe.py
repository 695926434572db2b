"""Twins of ``repro.nn.moe`` and of the JAX package's MoE kernel oracles for
the port: the same numpy inputs and the same ``init_moe`` weights (JAX's,
through ``convert``) through both packages on the CPU, where the port's
sort path runs its kernels' plain versions.

The reference's own test (``tests/test_moe.py``) holds einsum ≡ sort at
``rtol=2e-3, atol=2e-4`` and its property test at ``5e-3/5e-4``; the port
is held to the same.  Port against JAX, function by function, in float32
compute: ``tests/test_kernels.py``'s ``rtol=2e-4, atol=2e-5``.  The
``moe_dispatch`` plain version equals JAX's oracle and the Pallas kernel
(interpret mode) exactly, as the kernel equals it on the card; the
``moe_combine`` plain version equals JAX's oracle exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro.nn.moe as JM
import repro_torch.nn.layers as TL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.nn import moe as TM

IMPLS_TOL = dict(rtol=2e-3, atol=2e-4)          # tests/test_moe.py
PROPERTY_TOL = dict(rtol=5e-3, atol=5e-4)
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=6e-2, atol=3e-2)               # tests/test_kernels.py


@pytest.fixture(autouse=True)
def f32_compute(monkeypatch):
    """Both packages compute in float32 (the JAX test's x is float32 and
    promotes its bf16 weights; the port casts to one type)."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def make(t=32, d=16, e=8, k=2, ff=32, n_shared=0, cf=1.25, rsm="pre",
         seed=0, group_size=2048):
    """tests/test_moe.py's ``make``: (cfg(impl) for JAX, the same for the
    port, JAX params, port params, x as JAX array, x as tensor)."""
    fields = dict(n_experts=e, top_k=k, d_model=d, d_ff=ff,
                  n_shared=n_shared, capacity_factor=cf, router_softmax=rsm,
                  group_size=group_size)
    jcfg = lambda impl: JM.MoEConfig(impl=impl, **fields)
    tcfg = lambda impl: TM.MoEConfig(impl=impl, **fields)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg("einsum"))
    x = np.random.RandomState(seed).randn(t, d).astype(np.float32)
    return (jcfg, tcfg, jp, convert.from_jax_params(jp, device="cpu"),
            jnp.asarray(x), torch.from_numpy(x))


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# the port's own einsum ≡ sort (tests/test_moe.py's cases)
# ---------------------------------------------------------------------------

def test_einsum_equals_sort():
    """Array representation ≡ relational representation (same drops)."""
    _, cfg, _, p, _, x = make()
    o1, a1 = TM.moe_ffn(p, x, cfg("einsum"))
    o2, a2 = TM.moe_ffn(p, x, cfg("sort"))
    torch.testing.assert_close(o1, o2, **IMPLS_TOL)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)


def test_einsum_equals_sort_with_drops():
    """Tight capacity forces drops; priority must match between impls."""
    _, cfg, _, p, _, x = make(t=64, cf=0.5)
    gates, idx, _ = TM._route(p, x, cfg("sort"))
    cap = TM._capacity(64, cfg("sort"))
    assert int(torch.bincount(idx.reshape(-1), minlength=8).max()) > cap
    o1, _ = TM.moe_ffn(p, x, cfg("einsum"))
    o2, _ = TM.moe_ffn(p, x, cfg("sort"))
    torch.testing.assert_close(o1, o2, **IMPLS_TOL)


def test_post_softmax_router_and_shared():
    _, cfg, _, p, _, x = make(n_shared=1, rsm="post", seed=3)
    o1, _ = TM.moe_ffn(p, x, cfg("einsum"))
    o2, _ = TM.moe_ffn(p, x, cfg("sort"))
    torch.testing.assert_close(o1, o2, **IMPLS_TOL)
    assert torch.isfinite(o1).all()


def test_route_gates_normalised():
    _, cfg, _, p, _, x = make()
    gates, idx, aux = TM._route(p, x, cfg("einsum"))
    torch.testing.assert_close(gates.sum(-1), torch.ones(32), rtol=1e-5,
                               atol=0.0)
    assert tuple(idx.shape) == (32, 2) and float(aux) > 0


def test_shard_without_a_mesh_is_sort():
    """impl="shard" with no mesh runs the sort path (moe.py:270-277)."""
    _, cfg, _, p, _, x = make(seed=4)
    o1, _ = TM.moe_ffn(p, x, cfg("shard"))
    o2, _ = TM.moe_ffn(p, x, cfg("sort"))
    assert torch.equal(o1, o2)
    with pytest.raises(ValueError):
        TM.moe_ffn(p, x, cfg("dense"))


# tests/test_moe.py::test_property_impls_agree draws 10 (t, e, k, seed)
# with hypothesis; here a fixed sweep of the same ranges, each a case
PROPERTY_CASES = [(8, 4, 1, 0), (13, 4, 3, 7), (16, 8, 2, 11),
                  (21, 8, 3, 23), (29, 4, 2, 42), (32, 8, 1, 5),
                  (37, 8, 2, 64), (40, 4, 3, 77), (45, 8, 3, 90),
                  (48, 4, 1, 99)]


@pytest.mark.parametrize("t,e,k,seed", PROPERTY_CASES)
def test_property_impls_agree(t, e, k, seed):
    _, cfg, _, p, _, x = make(t=t, e=e, k=min(k, e), seed=seed)
    o1, _ = TM.moe_ffn(p, x, cfg("einsum"))
    o2, _ = TM.moe_ffn(p, x, cfg("sort"))
    torch.testing.assert_close(o1, o2, **PROPERTY_TOL)


# ---------------------------------------------------------------------------
# each function against its JAX counterpart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rsm", ["pre", "post"])
@pytest.mark.parametrize("groups", [1, 2])
def test_route_matches_jax(rsm, groups):
    jcfg, tcfg, jp, tp, jx, tx = make(t=32, rsm=rsm, seed=1)
    shape = (groups, 32 // groups, 16)
    jg, ji, ja = JM._route(jp, jx.reshape(shape), jcfg("sort"))
    tg, ti, ta = TM._route(tp, tx.reshape(shape), tcfg("sort"))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg, F32)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_einsum_and_sort_match_jax(cf):
    """_moe_einsum against JAX's; the port's one-launch sort path on one
    group against JAX's _moe_sort_one."""
    jcfg, tcfg, jp, tp, jx, tx = make(t=48, cf=cf, seed=2)
    jg, ji, _ = JM._route(jp, jx, jcfg("sort"))
    tg, ti, _ = TM._route(tp, tx, tcfg("sort"))
    close(TM._moe_einsum(tp, tx[None], tcfg("einsum"), tg[None], ti[None])[0],
          JM._moe_einsum(jp, jx[None], jcfg("einsum"), jg[None], ji[None])[0],
          F32)
    close(TM._moe_sort(tp, tx[None], tcfg("sort"), tg[None], ti[None])[0],
          JM._moe_sort_one(jp, jx, jcfg("sort"), jg, ji), F32)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("t,group_size", [(32, 16), (48, 16), (30, 16),
                                          (32, 2048)])
@pytest.mark.parametrize("n_shared,rsm", [(0, "pre"), (2, "pre"),
                                          (1, "post")])
def test_moe_ffn_matches_jax(impl, t, group_size, n_shared, rsm):
    """Several groups (t = 2 or 3 group sizes), one (t < group size, or t
    not a multiple: the group is all of t), shared experts, both routers."""
    jcfg, tcfg, jp, tp, jx, tx = make(t=t, n_shared=n_shared, rsm=rsm,
                                      seed=t, group_size=group_size)
    jo, ja = JM.moe_ffn(jp, jx, jcfg(impl))
    to, ta = TM.moe_ffn(tp, tx, tcfg(impl))
    assert to.shape == (t, 16) and to.dtype == torch.float32
    close(to, jo, F32)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)


def test_init_moe_has_the_jax_structure():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=12, n_shared=2)
    tp = TM.init_moe(torch.Generator().manual_seed(0), cfg, lead=(3,))
    jp = JM.init_moe(jax.random.PRNGKey(0), JM.MoEConfig(
        **dataclasses.asdict(cfg)))
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        convert.to_numpy(tp))[0])
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        assert flat_t[path].shape == (3,) + leaf.shape, path
    # dense_init's fan-in is the per-layer d_in (shape[-2])
    wi = TM.init_moe(torch.Generator().manual_seed(1),
                     dataclasses.replace(cfg, d_model=512, d_ff=64),
                     lead=(2,))["wi"]
    assert abs(float(wi.std()) - 512 ** -0.5) < 0.02 * 512 ** -0.5


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX oracles and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,slots,d", [(32, 64, 64), (64, 96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_matches_jax(t, slots, d, dtype):
    """tests/test_kernels.py::test_moe_dispatch's shapes: the plain
    version against the JAX oracle and the Pallas kernel in interpret mode
    (float32; the Pallas kernel's gate block is float32), exact."""
    rng = np.random.RandomState(t)
    x = rng.randn(t, d).astype(np.float32)
    idx = rng.randint(0, t, slots).astype(np.int32)
    gates = rng.rand(slots).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.moe_dispatch(tx, torch.from_numpy(idx), torch.from_numpy(gates))
    assert got.dtype == tx.dtype
    want = jref.moe_dispatch(jx, jnp.asarray(idx), jnp.asarray(gates))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if dtype == "float32":
        pallas = jops.moe_dispatch(jx, jnp.asarray(idx), jnp.asarray(gates),
                                   use_pallas=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_matches_jax(dtype):
    rng = np.random.RandomState(3)
    ys = rng.randn(40, 32).astype(np.float32)
    rows = np.sort(rng.randint(0, 12, 40)).astype(np.int32)
    rows[-3:] = 12                                  # padding is dropped
    jys = jnp.asarray(ys).astype(getattr(jnp, dtype))
    tys = torch.from_numpy(ys).to(getattr(torch, dtype))
    got = ops.moe_combine(tys, torch.from_numpy(rows), 12)
    want = jref.moe_combine(jys, jnp.asarray(rows), 12)
    assert got.dtype == tys.dtype and got.shape == (12, 32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_sort_path_combines_bf16_expert_rows_without_a_float32_copy(
        monkeypatch):
    """In bf16 compute the expert outputs reach ``relational_matmul`` in
    bf16, with no float32 copy, and the sort path gives the bits it gave
    with the copy (the widening is exact); against JAX's sort path in bf16
    compute, the bf16 kernel tolerance holds."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.bfloat16)
    jcfg, tcfg, jp, tp, jx, tx = make(t=48, n_shared=1, group_size=16, seed=7)
    tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got, _ = TM.moe_ffn(tp, tx, tcfg("sort"))
    seen = []
    relmm = ops.relational_matmul

    def with_copy(rows, cols, vals, b, m):
        seen.append(b.dtype)
        return relmm(rows, cols, vals, b.to(torch.float32), m)

    monkeypatch.setattr(ops, "relational_matmul", with_copy)
    want, _ = TM.moe_ffn(tp, tx, tcfg("sort"))
    assert seen == [torch.bfloat16] and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    jo, _ = JM.moe_ffn(jp, jx, jcfg("sort"))
    close(got, jo, BF16)


def test_sort_path_makes_one_dispatch_and_one_combine_launch(monkeypatch):
    """With the operands treated as on the card and the kernels sent to
    counting plain versions, one sort-path call over three groups launches
    ``moe_dispatch`` once (all groups' slots) and ``relational_matmul``
    once, and gives the CPU path's output."""
    _, cfg, _, p, _, x = make(t=48, n_shared=1, group_size=16, seed=6)
    want, _ = TM.moe_ffn(p, x, cfg("sort"))
    calls = {"dispatch": 0, "combine": 0}

    def counting(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(ops, "_on_host", lambda *ts: False)
    monkeypatch.setattr(ops, "_moe_cuda", counting("dispatch",
                                                   ref.moe_dispatch))
    monkeypatch.setattr(ops, "_relmm_cuda", counting("combine",
                                                     ref.relational_matmul))
    got, _ = TM.moe_ffn(p, x, cfg("sort"))
    assert calls == {"dispatch": 1, "combine": 1}
    assert torch.equal(got, want)
    TM.moe_ffn(p, x, cfg("einsum"))                 # no kernel on this path
    assert calls == {"dispatch": 1, "combine": 1}
