"""Twins of ``repro.optim`` for the port: ``sgd``, ``adamw`` (with and
without float32 masters), ``global_norm`` and ``clip_by_global_norm``
against the JAX package's on the same numpy trees, three updates each;
the int8 codec bit for bit; error feedback; ``compressed_psum`` as a
``torch.distributed`` all-reduce in a gloo group of one process, against
JAX's under ``vmap`` with a named axis of one.

Tolerance: rtol 1e-6, atol 1e-7.  Every operation is elementwise float32
in the same order in both packages; what may differ is a fused
multiply-add in XLA's CPU code (one float32 rounding, 6e-8 relative) and
the order of the global norm's sum within a leaf.
"""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import compression as jcomp
from repro.optim import global_norm as jglobal_norm
from repro.optim import sgd as jsgd
from repro_torch import convert
from repro_torch.optim import (GradScale, adamw, apply_grad_scale,
                               clip_by_global_norm, compression, global_norm,
                               sgd)
from repro_torch.tree import leaves

TOL = dict(rtol=1e-6, atol=1e-7)


def tree(rng, scale=1.0):
    """A nested tree of float32 arrays (dict keys out of sorted order,
    so leaf order matters)."""
    return {"w": (rng.randn(5, 7) * scale).astype(np.float32),
            "b": {"z": (rng.randn(7) * scale).astype(np.float32),
                  "a": (rng.randn(3, 2, 4) * scale).astype(np.float32)}}


def as_jax(t):
    return jax.tree.map(jnp.asarray, t)


def same(port_tree, jax_tree, tol=TOL):
    ours = leaves(port_tree)
    theirs = jax.tree.leaves(jax_tree)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("make", [
    lambda m: (sgd(0.05), jsgd(0.05)),
    lambda m: (adamw(1e-2), jadamw(1e-2)),
    lambda m: (adamw(3e-3, b1=0.8, weight_decay=0.3, mixed_precision=True),
               jadamw(3e-3, b1=0.8, weight_decay=0.3,
                      mixed_precision=True)),
], ids=["sgd", "adamw", "adamw_mixed_precision"])
def test_optimizer_matches_jax_over_three_updates(make):
    rng = np.random.RandomState(0)
    opt, jopt = make(None)
    p_np = tree(rng)
    params = convert.from_jax_params(p_np, device="cpu")
    jparams = as_jax(p_np)
    state, jstate = opt.init(params), jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for _ in range(3):
        g_np = tree(rng, 0.3)
        params, state = opt.update(convert.from_jax_params(g_np, "cpu"),
                                   state, params)
        jparams, jstate = jupdate(as_jax(g_np), jstate, jparams)
    same(params, jparams)
    same(state, jstate)
    if state != ():
        assert state["t"].dtype == torch.int32 and int(state["t"]) == 3


def test_adamw_updates_in_place():
    """The donated form: the returned trees are the given tensors."""
    rng = np.random.RandomState(1)
    params = convert.from_jax_params(tree(rng), device="cpu")
    opt = adamw(1e-2)
    state = opt.init(params)
    before = [p.data_ptr() for p in leaves(params)]
    new, new_state = opt.update(convert.from_jax_params(tree(rng), "cpu"),
                                state, params)
    assert new is params and new_state is state
    assert [p.data_ptr() for p in leaves(new)] == before


def test_opt_state_converts_both_ways():
    rng = np.random.RandomState(2)
    jopt = jadamw(1e-2, mixed_precision=True)
    jparams = as_jax(tree(rng))
    jstate = jopt.init(jparams)
    jparams, jstate = jax.jit(jopt.update)(as_jax(tree(rng)), jstate,
                                           jparams)
    state = convert.from_jax_opt_state(jstate, device="cpu")
    assert sorted(state) == ["m", "master", "t", "v"]
    assert state["t"].dtype == torch.int32 and int(state["t"]) == 1
    same(state, jstate, dict(rtol=0, atol=0))
    back = convert.to_jax_opt_state(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert convert.from_jax_opt_state(()) == ()


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    rng = np.random.RandomState(3)
    g_np = tree(rng)
    grads = convert.from_jax_params(g_np, device="cpu")
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jglobal_norm(as_jax(g_np))), **TOL)
    clipped, norm = clip_by_global_norm(grads, max_norm)
    jclipped, jnorm = jclip(as_jax(g_np), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), **TOL)
    same(clipped, jclipped)


def torch_tree(rng, scale=1.0):
    return convert.from_jax_params(tree(rng, scale), device="cpu")


def clone(t):
    return [x.clone() for x in leaves(t)]


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped",
                                                      "unclipped"])
@pytest.mark.parametrize("divisor", [1, 2, 3])
@pytest.mark.parametrize("mixed_precision", [False, True])
def test_scaled_update_is_the_old_sequence_bit_for_bit(mixed_precision,
                                                       divisor, max_norm):
    """``clip_by_global_norm(..., divide_by=k)`` and AdamW's update with
    its ``GradScale`` give the norm, the parameters and the state that the
    old sequence gives (``g.div_(k)`` for k > 1, the in-place clip, the
    update), bit for bit, over three updates; the gradients they get stay
    as they were until the update applies the scale."""
    rng = np.random.RandomState(divisor)
    opt = adamw(1e-2, mixed_precision=mixed_precision)
    p_np = tree(rng)
    old_p = convert.from_jax_params(p_np, device="cpu")
    new_p = convert.from_jax_params(p_np, device="cpu")
    old_st, new_st = opt.init(old_p), opt.init(new_p)
    for _ in range(3):
        g_np = tree(rng, 0.3 * divisor)
        old_g = convert.from_jax_params(g_np, "cpu")
        new_g = convert.from_jax_params(g_np, "cpu")
        if divisor > 1:
            for g in leaves(old_g):
                g.div_(divisor)
        old_g, old_norm = clip_by_global_norm(old_g, max_norm)
        old_p, old_st = opt.update(old_g, old_st, old_p)
        kept = clone(new_g)
        new_g, new_norm, scale = clip_by_global_norm(new_g, max_norm,
                                                     divide_by=divisor)
        assert isinstance(scale, GradScale) and scale.divisor == divisor
        assert all(torch.equal(a, b) for a, b in zip(leaves(new_g), kept))
        assert torch.equal(new_norm, old_norm)
        new_p, new_st = opt.update(new_g, new_st, new_p, grad_scale=scale)
        for a, b in zip(leaves((old_p, old_st)), leaves((new_p, new_st)),
                        strict=True):
            assert torch.equal(a, b)
    assert (float(scale.factor) < 1) == (max_norm < 1)


def test_clip_by_global_norm_default_call_is_unchanged():
    """Without ``divide_by`` the clip scales in place and returns (grads,
    norm), as the JAX package's does; ``apply_grad_scale`` of the deferred
    form's scale gives the same leaves."""
    rng = np.random.RandomState(5)
    g_np = tree(rng)
    grads = torch_tree(np.random.RandomState(5))
    out = clip_by_global_norm(grads, 0.5)
    assert len(out) == 2 and out[0] is grads
    norm = float(jglobal_norm(as_jax(g_np)))
    np.testing.assert_allclose(float(out[1]), norm, **TOL)
    factor = min(1.0, 0.5 / (norm + 1e-9))
    for a, b in zip(leaves(grads), jax.tree.leaves(g_np)):
        np.testing.assert_allclose(a.numpy(), b * factor, **TOL)
    deferred = torch_tree(np.random.RandomState(5))
    _, norm2, scale = clip_by_global_norm(deferred, 0.5, divide_by=1)
    assert torch.equal(norm2, out[1])
    applied = apply_grad_scale(deferred, scale)
    assert applied is deferred
    assert all(torch.equal(a, b) for a, b in zip(leaves(deferred),
                                                  leaves(grads)))


def test_global_norm_divides_each_leaf_first():
    """``global_norm(tree, k)`` is the norm of the leaves divided by k, the
    quotient taken in the leaf's type as ``div_`` takes it."""
    grads = torch_tree(np.random.RandomState(6))
    want = global_norm([g / 3 for g in leaves(grads)])
    assert torch.equal(global_norm(grads, 3), want)
    assert torch.equal(global_norm(grads, 1), global_norm(grads))


def test_adamw_folds_the_scale_and_sgd_does_not():
    assert adamw(1e-2).folds_grad_scale
    assert not sgd(0.1).folds_grad_scale


def test_sgd_matches_formula():
    p = {"w": torch.ones(3)}
    new, _ = sgd(0.1).update({"w": torch.full((3,), 2.0)}, (), p)
    np.testing.assert_allclose(new["w"].numpy(), 0.8)


def test_adamw_reduces_loss():
    opt = adamw(1e-1, weight_decay=0.0)
    p = {"w": torch.tensor([5.0])}
    st = opt.init(p)
    for _ in range(50):
        p, st = opt.update({"w": 2 * p["w"]}, st, p)
    assert abs(float(p["w"][0])) < 1.0


@pytest.mark.parametrize("n", [1000, 512, 7])
def test_int8_codec_is_jaxs_bit_for_bit(n):
    """Scales, codes and the dequantised values all equal JAX's, with a
    ragged tail (padding) and ties at .5 in the codes (round half to
    even)."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 3.0]               # a block max of 3 or more
    q, s, meta = compression.quantize_int8(torch.from_numpy(x))
    jq, js, jmeta = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert meta == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s, meta).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, jmeta)))


def test_int8_roundtrip_error_small():
    x = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    q, s, meta = compression.quantize_int8(x)
    err = (compression.dequantize_int8(q, s, meta) - x).abs()
    assert float(err.max()) < float(x.abs().max()) / 100


def test_error_feedback_accumulates_to_zero():
    """Σ residuals stays bounded: compressed sum → true sum."""
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(512).astype(np.float32)) * 1e-3
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, s, meta, err = compression.compress_with_feedback(g, err)
        total = total + compression.dequantize_int8(q, s, meta)
    np.testing.assert_allclose((total + err).numpy(), (g * 50).numpy(),
                               rtol=1e-4, atol=1e-6)


def test_compressed_psum_in_a_gloo_group(tmp_path):
    """One process, world size 1: the mean of the dequantised blocks is
    those blocks, and both outputs equal JAX's under a named axis of
    one."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rng = np.random.RandomState(4)
        g_np, e_np = tree(rng), tree(rng, 1e-3)
        red, errs = compression.compressed_psum(
            convert.from_jax_params(g_np, "cpu"),
            convert.from_jax_params(e_np, "cpu"))
    finally:
        dist.destroy_process_group()
    jred, jerrs = jax.vmap(
        lambda g, e: jcomp.compressed_psum(g, e, "pod"), axis_name="pod")(
        jax.tree.map(lambda a: jnp.asarray(a)[None], g_np),
        jax.tree.map(lambda a: jnp.asarray(a)[None], e_np))
    exact = dict(rtol=0, atol=0)
    same(red, jax.tree.map(lambda a: a[0], jred), exact)
    same(errs, jax.tree.map(lambda a: a[0], jerrs), exact)
    assert sorted(red) == sorted(g_np) and sorted(red["b"]) == ["a", "z"]
    assert sorted(errs["b"]) == ["a", "z"]
    assert compression.init_error(red)["w"].dtype == torch.float32
