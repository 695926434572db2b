"""The port's kernel front on the CPU: each plain PyTorch version
(``repro_torch.kernels.ref``) against the JAX package's Pallas kernel in
interpret mode and its jnp oracle, on the same seeded numpy inputs, and the
dispatch rule (CPU operands → plain version, no launch counted).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions at the sweep and main-path shapes, and
``tests/test_torch_cuda.py`` does at small shapes.
Tolerances are ``tests/test_kernels.py``'s: float32 ``rtol=2e-4,
atol=2e-5`` (another summation order), bf16 ``6e-2/3e-2``, gathers exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_sigmoid_matmul as fsm_mod
from repro_torch.kernels import onehot_embed as embed_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import relational_matmul as relmm_mod

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=6e-2, atol=3e-2)


def rnd(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def both(a: np.ndarray, torch_dtype=None):
    """The same numpy array as a jnp array and a CPU tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return jnp.asarray(a), (t.to(torch_dtype) if torch_dtype else t)


def f32(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("m,k,n,blk_t,blk_n",
                         [(8, 16, 128, 32, 64), (16, 32, 256, 128, 128)])
def test_relational_matmul_dense_coo(m, k, n, blk_t, blk_n):
    rng = np.random.RandomState(42)
    rows_np = np.repeat(np.arange(m, dtype=np.int32), k)
    cols_np = np.tile(np.arange(k, dtype=np.int32), m)
    (jr, tr), (jc, tc) = both(rows_np), both(cols_np)
    (jv, tv), (jb, tb) = both(rnd(rng, m * k)), both(rnd(rng, k, n))
    got = ops.relational_matmul(tr, tc, tv, tb, m)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    pallas = jops.relational_matmul(jr, jc, jv, jb, m, use_pallas=True,
                                    blk_t=blk_t, blk_n=blk_n)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.relational_matmul(jr, jc, jv, jb, m)), **F32)


@pytest.mark.parametrize("nnz,pad", [(32, 0), (48, 16), (8, 56)])
def test_relational_matmul_sparse_padding(nnz, pad):
    """Padding tuples (row == m) are dropped, as the group-by drops them."""
    rng = np.random.RandomState(nnz + pad)
    m, k, n = 16, 32, 128
    rows_np = np.concatenate([np.sort(rng.randint(0, m, nnz)),
                              np.full(pad, m)]).astype(np.int32)
    (jr, tr) = both(rows_np)
    (jc, tc) = both(rng.randint(0, k, nnz + pad).astype(np.int32))
    (jv, tv), (jb, tb) = both(rnd(rng, nnz + pad)), both(rnd(rng, k, n))
    got = ops.relational_matmul(tr, tc, tv, tb, m)
    pallas = jops.relational_matmul(jr, jc, jv, jb, m, use_pallas=True,
                                    blk_t=min(64, nnz + pad), blk_n=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.relational_matmul(jr, jc, jv, jb, m)), **F32)


@pytest.mark.parametrize("m,k,n,nnz,pad", [(8, 16, 128, 128, 0),
                                            (16, 32, 256, 48, 16)])
def test_relational_matmul_bf16_b(m, k, n, nnz, pad):
    """b in bf16, as the MoE combine gives it: the port against the JAX
    oracle and the Pallas kernel (interpret mode), which both widen b to
    float32, on the same bf16 values."""
    rng = np.random.RandomState(m + nnz)
    rows_np = np.concatenate([np.sort(rng.randint(0, m, nnz)),
                              np.full(pad, m)]).astype(np.int32)
    (jr, tr), (jc, tc) = both(rows_np), both(
        rng.randint(0, k, nnz + pad).astype(np.int32))
    jv, tv = both(rnd(rng, nnz + pad))
    b = rnd(rng, k, n)
    jb, tb = jnp.asarray(b).astype(jnp.bfloat16), torch.from_numpy(b).to(
        torch.bfloat16)
    got = ops.relational_matmul(tr, tc, tv, tb, m)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    pallas = jops.relational_matmul(jr, jc, jv, jb, m, use_pallas=True,
                                    blk_t=min(64, nnz + pad), blk_n=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.relational_matmul(jr, jc, jv, jb, m)), **F32)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (128, 512, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sigmoid_matmul(m, k, n, dtype):
    rng = np.random.RandomState(7)
    x_np, w_np = rnd(rng, m, k), rnd(rng, k, n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, tx = jnp.asarray(x_np).astype(jdt), torch.from_numpy(x_np).to(tdt)
    jw, tw = jnp.asarray(w_np).astype(jdt), torch.from_numpy(w_np).to(tdt)
    got = ops.fused_sigmoid_matmul(tx, tw)
    assert got.dtype == tdt and got.shape == (m, n)
    tol = F32 if dtype == "float32" else BF16
    pallas = jops.fused_sigmoid_matmul(jx, jw, use_pallas=True)
    np.testing.assert_allclose(f32(got), np.asarray(pallas, np.float32), **tol)
    np.testing.assert_allclose(f32(got), np.asarray(
        jref.fused_sigmoid_matmul(jx, jw), np.float32), **tol)


@pytest.mark.parametrize("t,v,d", [(16, 100, 64), (128, 333, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_embed(t, v, d, dtype):
    """Exact: a gather moves the bits it finds."""
    rng = np.random.RandomState(t)
    ids_np = rng.randint(0, v, t).astype(np.int32)
    table_np = rnd(rng, v, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jt, tt = jnp.asarray(table_np).astype(jdt), torch.from_numpy(table_np).to(tdt)
    got = ops.onehot_embed(torch.from_numpy(ids_np), tt)
    assert got.dtype == tdt and got.shape == (t, d)
    pallas = jops.onehot_embed(jnp.asarray(ids_np), jt, use_pallas=True)
    np.testing.assert_array_equal(f32(got), np.asarray(pallas, np.float32))
    np.testing.assert_array_equal(f32(got), np.asarray(
        jref.onehot_embed(jnp.asarray(ids_np), jt), np.float32))


def test_onehot_with_identity_is_one_hot():
    """§4.1: onehot(y)·I_C is the one-hot label matrix."""
    y = np.array([0, 2, 1, 2, 9, 3], np.int32)
    got = ops.onehot_embed(torch.from_numpy(y), torch.eye(10))
    np.testing.assert_array_equal(got.numpy(), np.eye(10, dtype=np.float32)[y])


def _counts():
    return (relmm_mod.relational_matmul.launches,
            fsm_mod.fused_sigmoid_matmul.launches,
            embed_mod.onehot_embed.launches)


def test_cpu_operands_take_the_plain_version_and_count_no_launch():
    before = _counts()
    rng = np.random.RandomState(0)
    x, w = torch.from_numpy(rnd(rng, 5, 4)), torch.from_numpy(rnd(rng, 4, 3))
    torch.testing.assert_close(ops.fused_sigmoid_matmul(x, w),
                               ref.fused_sigmoid_matmul(x, w), rtol=0, atol=0)
    rows = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    cols = torch.tensor([1, 3, 0, 2], dtype=torch.int32)
    vals = torch.ones(4)
    torch.testing.assert_close(
        ops.relational_matmul(rows, cols, vals, w, 3),
        ref.relational_matmul(rows, cols, vals, w, 3), rtol=0, atol=0)
    ops.onehot_embed(torch.tensor([1, 0], dtype=torch.int32), w)
    assert _counts() == before


def test_no_fallback_off_the_cpu():
    """Operands that are neither all-CPU nor all-CUDA raise; the kernel
    wrappers refuse host tensors instead of running the plain version."""
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        ops.fused_sigmoid_matmul(meta, torch.empty((3, 2), device="meta"))
    with pytest.raises(ValueError):
        ops.fused_sigmoid_matmul(torch.ones(4, 3), torch.empty((3, 2),
                                                               device="meta"))
    x, w = torch.ones(4, 3), torch.ones(3, 2)
    before = _counts()
    with pytest.raises(ValueError):
        fsm_mod.fused_sigmoid_matmul(x, w)
    with pytest.raises(ValueError):
        embed_mod.onehot_embed(torch.zeros(2, dtype=torch.int32), x)
    with pytest.raises(ValueError):
        relmm_mod.relational_matmul(torch.zeros(2, dtype=torch.int32),
                                    torch.zeros(2, dtype=torch.int32),
                                    torch.ones(2), w, 1)
    assert _counts() == before


def test_plain_relational_matmul_drops_out_of_range_rows_like_segment_sum():
    rng = np.random.RandomState(3)
    rows_np = np.array([2, 0, 5, 1, -1, 3], np.int32)       # unsorted, 5/-1 out
    cols_np = rng.randint(0, 4, 6).astype(np.int32)
    (jr, tr), (jc, tc) = both(rows_np), both(cols_np)
    (jv, tv), (jb, tb) = both(rnd(rng, 6)), both(rnd(rng, 4, 3))
    np.testing.assert_allclose(
        ref.relational_matmul(tr, tc, tv, tb, 4).numpy(),
        np.asarray(jref.relational_matmul(jr, jc, jv, jb, 4)), **F32)


def test_every_kernel_source_is_built():
    """Each ``csrc/*.cu`` is in ``build.SOURCES`` (so ``build.build()``
    compiles it with the others), and each listed source exists."""
    from repro_torch.kernels import build
    on_disk = {p.stem for p in build.CSRC.glob("*.cu")}
    assert on_disk == set(build.SOURCES)
    assert "flash_attention_tc" in on_disk


@pytest.mark.parametrize("m,k,n,tile,n_blocks", [
    (2000, 784, 200, "wide", 250),      # the first layer: 50 x 5, no ragged tile
    (2000, 200, 10, "narrow", 125),     # the output layer: all 10 columns a block
    (2000, 200, 16, "narrow", 125),
    (2000, 200, 17, "wide", 50),
    (81, 100, 39, "wide", 3),
    (79, 100, 41, "wide", 4),
    (150, 4, 3, "narrow", 10)])
def test_fused_sigmoid_matmul_instance_by_shape(m, k, n, tile, n_blocks):
    """The wrapper picks the kernel's tile instance from the shape alone,
    and both main-path layers fill more than the 32 blocks that a single
    64 x 64 tile gives the output layer."""
    assert fsm_mod.instance(m, k, n) == tile
    assert fsm_mod.blocks(m, k, n) == n_blocks


@pytest.mark.parametrize("m,k,n,nnz,kind,tile_n,split", [
    (2000, 784, 200, 1_568_000, "slab", 64, 2),     # z_xh = img · w_xh
    (2000, 200, 10, 400_000, "slab", 16, 4),        # z_ho = a_xh · w_ho
    (2000, 10, 200, 20_000, "stream", 512, 1),      # Eq8: 10 tuples a row
    (200, 2000, 10, 400_000, "slab", 16, 8),        # Eq10 a_xh^T · d_ho
    (784, 2000, 200, 1_568_000, "slab", 16, 4),     # Eq11 img^T · d_xh
    (8000, 60416, 2048, 48_000, "stream", 512, 1),  # the MoE combine
    (64, 13504, 3, 14_016, "slab", 4, 16),          # the widest k that fits
    (64, 13505, 3, 14_016, "stream", 512, 1),       # one row more
    (40, 300, 3, 100, "stream", 512, 1),            # fewer tuples than k
    (40, 30, 3, 1279, "stream", 512, 1),            # segments under 32
    (40, 30, 3, 1280, "slab", 4, 16)])
def test_relational_matmul_schedule_by_shape(m, k, n, nnz, kind, tile_n,
                                             split):
    """The wrapper picks the second pass's schedule from the shape alone:
    a slab of b in shared memory for the MLP's products with long
    segments, a stream for the combine and for Eq8's 10 tuples a row; the
    same for bf16 and float32 b (so the sums run in the same order); a
    slab never needs more than a block's 232,448 bytes, and its grid
    fills the 132 SMs."""
    plans = [relmm_mod.schedule(m, k, n, nnz, dt)
             for dt in (torch.float32, torch.bfloat16)]
    for plan in plans:
        assert (plan.kind, plan.tile_n, plan.split) == (kind, tile_n, split)
        if kind == "slab":
            assert plan.smem == k * tile_n * 4 + relmm_mod.STAGE_BYTES
            assert plan.smem <= relmm_mod.SMEM_LIMIT == 232_448
            assert plan.blocks <= 4 * 132 and plan.rows_per_block >= 1
            assert -(-m // plan.rows_per_block) * -(-n // tile_n) == \
                plan.blocks
    assert (plans[0].vector, plans[1].vector) == ((4, 8) if kind == "stream"
                                                  else (0, 0))


def test_fused_sigmoid_matmul_copy_width():
    """16-byte copies for float32 rows of whole 16-byte units from an
    aligned base (bit 0 x, bit 1 w); 4-byte copies otherwise, and always
    for bf16."""
    x, w = torch.zeros(2000, 784), torch.zeros(784, 200)
    assert fsm_mod.chunks(x, w) == 3
    a, w_ho = torch.zeros(2000, 200), torch.zeros(200, 10)
    assert fsm_mod.chunks(a, w_ho) == 1                 # w rows of 40 B
    assert fsm_mod.chunks(torch.zeros(5, 30), torch.zeros(30, 8)) == 2
    flat = torch.zeros(4 * 784 + 1)
    assert fsm_mod.chunks(flat[1:].view(4, 784), torch.zeros(784, 8)) == 2
    assert fsm_mod.chunks(torch.zeros(4, 8), flat[1:33].view(8, 4)) == 1
    bf = torch.zeros(2000, 784, dtype=torch.bfloat16)
    assert fsm_mod.chunks(bf, w.to(torch.bfloat16)) == 0


def test_flash_tma_rule_for_bf16_operands():
    """What the bf16 flash kernel reads in place (TMA: a 16-byte-aligned
    base, batch/head/sequence strides of whole 16-byte units; an axis of
    extent 1 is never stepped along) and what ``ops`` must copy first;
    float32 operands only need a unit last stride."""
    from repro_torch.kernels import flash_attention as flash_mod
    bf = torch.zeros(2, 100, 8, 128, dtype=torch.bfloat16)
    assert flash_mod.takes(bf.transpose(1, 2))          # head-split view
    zamba2 = torch.zeros(1, 64, 32, 80, dtype=torch.bfloat16)  # rows of 160 B
    assert flash_mod.takes(zamba2.transpose(1, 2))
    assert flash_mod._strides(zamba2.transpose(1, 2)) == (64 * 2560, 80, 2560)
    assert flash_mod.takes(bf[:1, :, :, :64].transpose(1, 2))
    assert not flash_mod.takes(bf[..., 1:65])           # base 2 bytes off
    assert not flash_mod.takes(torch.zeros(1, 2, 5, 68, dtype=torch.bfloat16)
                               [..., :64])              # rows of 136 bytes
    assert not flash_mod.takes(bf.transpose(2, 3))      # D not innermost
    odd = torch.zeros(1, 1, 1, 72, dtype=torch.bfloat16)[..., 8:40]
    assert flash_mod.takes(odd)     # extent-1 axes: their strides unused
    assert flash_mod._strides(odd) == (32, 32, 32)
    f = torch.zeros(1, 2, 5, 68)[..., 1:65]
    assert flash_mod.takes(f) and not flash_mod.takes(f.transpose(2, 3))


def test_flash_bf16_scores_on_the_cpu_is_the_plain_version():
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rnd(rng, 1, 2, 10, 32)) for _ in range(3))
    got = ops.flash_attention(q, k, v, bf16_scores=True)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.flash_attention(q, k, v, bf16_scores=True))
    assert not torch.equal(got, ref.flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# The numerics the card kernels rely on, emulated on the CPU.

SCAN = dict(rtol=3e-4, atol=3e-4)               # tests/test_kernels.py


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: add half a unit of the
    13 dropped bits to the int32 word, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as the float32 flash kernel takes it on the tensor cores: three
    TF32 products summed in float32, the small terms first."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _causal_attention(q, k, v, mm):
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    n = s.shape[-1]
    s = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm(p, v) / p.sum(dim=-1, keepdim=True)


def test_tf32_split_is_exact_to_2_pow_minus_22():
    """hi and lo are TF32 words (13 low bits clear) and x - hi - lo is at
    most 2^-22 |x|; one TF32 word alone is off by up to 2^-11 |x|."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rnd(rng, 100000) * 10.0 ** rng.randint(
        -20, 20, 100000)).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64 = x.double()
    rest = (x64 - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -22 * x64.abs()).all()
    one = (x64 - hi.double()).abs()
    assert (one <= 2.0 ** -11 * x64.abs()).all()
    assert (one > 2.0 ** -14 * x64.abs()).float().mean() > 0.5


@pytest.mark.parametrize("b,h,s,d,dv", [(1, 4, 256, 192, 128),
                                        (1, 4, 512, 128, 128),
                                        (1, 4, 512, 80, 80)])
def test_3xtf32_attention_meets_float32_and_one_tf32_does_not(b, h, s, d,
                                                              dv):
    """Causal attention with both products in 3xTF32 meets the float32
    tolerance against a float64 oracle at MLA's, Yi-6B's and Zamba2's head
    dims; with single TF32 products it does not."""
    rng = np.random.RandomState(s + d)
    q, k = (torch.from_numpy(rnd(rng, b, h, s, d)) for _ in range(2))
    v = torch.from_numpy(rnd(rng, b, h, s, dv))
    oracle = _causal_attention(q.double(), k.double(), v.double(),
                               torch.matmul)
    three = _causal_attention(q, k, v, _mm_3xtf32)
    torch.testing.assert_close(three.double(), oracle, **F32)
    one = _causal_attention(q, k, v, _mm_tf32)
    assert not torch.allclose(one.double(), oracle, **F32)


def _rwkv6_factored(r, k, v, w, u, s0):
    """The recurrence in the order of the card kernel, float32: the u term
    once a step, a_t = Σ_i r_i u_i k_i, then o_t = r_t·S + a_t v_t with S
    before the update, and S ← w S + k vᵀ."""
    state, outs = s0.clone(), []
    for t in range(r.shape[-2]):
        rt, kt, vt, wt = (x[..., t, :] for x in (r, k, v, w))
        a = (rt * (u * kt)).sum(-1, keepdim=True)
        outs.append(torch.einsum("...i,...ij->...j", rt, state) + a * vt)
        state = wt[..., :, None] * state + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=-2), state


@pytest.mark.parametrize("bh,s,n", [(2, 32, 16), (4, 64, 32), (1, 128, 64),
                                    (256, 1, 64), (8, 7, 64), (8, 77, 32)])
def test_factored_rwkv6_recurrence_meets_scan_tol(bh, s, n):
    """The factored form in float32 against the port's plain version and the
    JAX package's oracle, over ``chip_smoke.check_rwkv6``'s sweep."""
    rng = np.random.RandomState(bh + s + n)
    r, k, v = (rnd(rng, bh, s, n) for _ in range(3))
    w = (rng.rand(bh, s, n) * 0.5 + 0.4).astype(np.float32)
    u, s0 = rnd(rng, bh, n), (rnd(rng, bh, n, n) * 0.1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    o, s_fin = _rwkv6_factored(*args)
    o_ref, s_ref = ref.rwkv6_scan(*args)
    torch.testing.assert_close(o, o_ref, **SCAN)
    torch.testing.assert_close(s_fin, s_ref, **SCAN)
    jo, js = jref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **SCAN)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), **SCAN)
