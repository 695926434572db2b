"""The chunked twin of the ``rwkv6_scan_bwd`` kernel against JAX's gradient.

``ref.rwkv6_scan_bwd_chunked`` computes the RWKV-6 recurrence's gradient
the way the card kernel does (the state before each chunk of 64 steps and G
after it, sub-chunks of 16 with their own boundary states, running products
of the decay and no quotient of them); the CPU route of ``ops`` keeps the
sequential ``ref.rwkv6_scan_bwd``.  Here the twin is held against
``jax.vjp`` of the JAX oracle ``repro.kernels.ref.rwkv6_scan`` (the
``lax.scan`` JAX differentiates) and against the sequential backward, at
head dims 16, 32 and 64 and S 1, 7, 77 and 128 (ragged chunks), with and
without ds_fin.

Inputs.  ``tests/test_kernels.py``'s (w uniform in [0.4, 0.9)), and a wide
decay, w = exp(-exp(x)) with x uniform in [-6, 5), as a trained RWKV-6's
decays spread: it holds exact float32 zeros (exp(-e^5) underflows) and
values within 0.003 of 1.  The sequential backward meets the same wide
decays against JAX too.

Tolerances.  float32 at ``SCAN_TOL`` (rtol 3e-4, atol 3e-4,
``tests/test_kernels.py``'s bound for the scan, which the card tests hold
the kernel to): the twin and JAX sum the same products in another order
over up to 128 steps.  float64 at 1e-10: the twin is the sequential
backward's function exactly, its sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jref
from repro_torch.kernels import ref

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
F64 = dict(rtol=1e-10, atol=1e-10)
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def operands(seed, lead, s, n, wide=False, dtype=np.float32):
    """r, k, v, w, u, s0, do, ds_fin: w uniform in [0.4, 0.9), or the wide
    decay exp(-exp(x)), x uniform in [-6, 5); s0 = 0.1·randn."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(*lead, s, n) for _ in range(3))
    w = (np.exp(-np.exp(rng.uniform(-6, 5, size=(*lead, s, n)))) if wide
         else rng.rand(*lead, s, n) * 0.5 + 0.4)
    u, s0 = rng.randn(*lead, n), rng.randn(*lead, n, n) * 0.1
    do, ds_fin = rng.randn(*lead, s, n), rng.randn(*lead, n, n)
    return [a.astype(dtype) for a in (r, k, v, w, u, s0, do, ds_fin)]


def jax_grads(r, k, v, w, u, s0, do, ds_fin):
    """jax.vjp of the JAX oracle with cotangents (do, ds_fin or zeros)."""
    _, vjp = jax.vjp(jref.rwkv6_scan,
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    ds = np.zeros_like(s0) if ds_fin is None else ds_fin
    return [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(ds)))]


def check(got, want, tol):
    for name, g, j in zip(NAMES, got, want, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == j.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, j, err_msg=name, **tol)


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
@pytest.mark.parametrize("with_ds_fin", [False, True])
def test_chunked_backward_matches_jax_vjp(n, s, with_ds_fin):
    """float32 (BH, S, N) operands against jax.vjp at SCAN_TOL; S 77 and
    128 end in a ragged chunk or sub-chunk and walk two chunks."""
    r, k, v, w, u, s0, do, ds_fin = operands(s + 3 * n, (3,), s, n)
    ds_fin = ds_fin if with_ds_fin else None
    want = jax_grads(r, k, v, w, u, s0, do, ds_fin)
    got = ref.rwkv6_scan_bwd_chunked(
        *map(torch.from_numpy, (r, k, v, w, u, s0, do)),
        None if ds_fin is None else torch.from_numpy(ds_fin))
    assert all(g.dtype == torch.float32 for g in got)
    check(got, want, SCAN_TOL)


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
@pytest.mark.parametrize("with_ds_fin", [False, True])
def test_chunked_backward_is_the_plain_backward_in_float64(n, s,
                                                           with_ds_fin):
    """float64: the twin equals the sequential backward within 1e-10."""
    args = [torch.from_numpy(a) for a in operands(s * n, (2,), s, n,
                                                  dtype=np.float64)]
    ds_fin = args[7] if with_ds_fin else None
    got = ref.rwkv6_scan_bwd_chunked(*args[:7], ds_fin)
    want = ref.rwkv6_scan_bwd(*args[:7], ds_fin)
    for name, g, j in zip(NAMES, got, want, strict=True):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, j, msg=name, **F64)


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
def test_chunked_backward_with_wide_decays(n, s):
    """The wide decay (exact zeros and values within 0.003 of 1) against
    jax.vjp in float32 at SCAN_TOL and the sequential backward in float64
    at 1e-10, every gradient finite."""
    r, k, v, w, u, s0, do, ds_fin = operands(7 * s + n, (3,), s, n,
                                             wide=True)
    assert (w == 0).any() or s * n < 600
    got = ref.rwkv6_scan_bwd_chunked(
        *map(torch.from_numpy, (r, k, v, w, u, s0, do, ds_fin)))
    check(got, jax_grads(r, k, v, w, u, s0, do, ds_fin), SCAN_TOL)
    a64 = [torch.from_numpy(a.astype(np.float64))
           for a in (r, k, v, w, u, s0, do, ds_fin)]
    for name, g, j in zip(NAMES, ref.rwkv6_scan_bwd_chunked(*a64),
                          ref.rwkv6_scan_bwd(*a64), strict=True):
        torch.testing.assert_close(g, j, msg=name, **F64)


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
def test_plain_backward_with_wide_decays_matches_jax_vjp(n, s):
    """The sequential plain backward (the oracle of the card tests) on the
    wide decay against jax.vjp at SCAN_TOL, every gradient finite."""
    r, k, v, w, u, s0, do, ds_fin = operands(5 * s + n, (3,), s, n,
                                             wide=True)
    got = ref.rwkv6_scan_bwd(
        *map(torch.from_numpy, (r, k, v, w, u, s0, do, ds_fin)))
    check(got, jax_grads(r, k, v, w, u, s0, do, ds_fin), SCAN_TOL)


@pytest.mark.parametrize("s", [15, 16, 17, 63, 64, 65, 129])
def test_chunked_backward_at_the_chunk_edges(s):
    """S on either side of a sub-chunk (16 steps) and a chunk (64), float64
    against the sequential backward, and with ``chunk=32`` (two sub-chunks
    a chunk) the same function."""
    args = [torch.from_numpy(a) for a in operands(s, (2,), s, 16,
                                                  dtype=np.float64)]
    want = ref.rwkv6_scan_bwd(*args)
    for chunk in (64, 32):
        got = ref.rwkv6_scan_bwd_chunked(*args, chunk=chunk)
        for name, g, j in zip(NAMES, got, want, strict=True):
            torch.testing.assert_close(g, j, msg=f"{name} {chunk}", **F64)


def test_chunked_backward_takes_the_layers_call():
    """The layer's call in float64: (B, S, H, N) arrays seen as (B, H, S,
    N), u (H, N) expanded over the batch, no ds_fin and no ds0, as training
    calls the kernel; du per row of state."""
    b, h, s, n = 2, 3, 70, 32
    r, k, v, w, _, _, do, _ = operands(11, (b, s), h, n, dtype=np.float64)
    rng = np.random.RandomState(12)
    u = torch.from_numpy(rng.randn(h, n)).expand(b, h, n)
    s0 = torch.from_numpy(rng.randn(b, h, n, n) * 0.1)
    seq = [torch.from_numpy(a).transpose(1, 2) for a in (r, k, v, w, do)]
    got = ref.rwkv6_scan_bwd_chunked(*seq[:4], u, s0, seq[4], None, False)
    want = ref.rwkv6_scan_bwd(*seq[:4], u, s0, seq[4], None, False)
    assert got[5] is None and want[5] is None
    assert got[4].shape == (b, h, n)
    for name, g, j in zip(NAMES[:5], got, want):
        torch.testing.assert_close(g, j, msg=name, **F64)
