"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc``) every test here skips
with its reason.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  ``chip_smoke.py`` covers the same kernels at
the full main-path shapes.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import nn2sql
from repro_torch.core.engine import Engine
from repro_torch.core.relational import RelTensor
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import fused_sigmoid_matmul as fsm_mod
from repro_torch.kernels import moe_dispatch as moe_mod
from repro_torch.kernels import onehot_embed as embed_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import relational_matmul as relmm_mod
from repro_torch.kernels import rwkv6_scan as scan_mod
from repro_torch.kernels import tuple_dot as dot_mod

pytestmark = pytest.mark.cuda

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=6e-2, atol=3e-2)
SCAN = dict(rtol=3e-4, atol=3e-4)               # tests/test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain "
                    "versions against the JAX package instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rnd(rng, *shape, device, dtype=torch.float32):
    return torch.tensor(rng.randn(*shape), dtype=torch.float32,
                        device=device).to(dtype)


@pytest.mark.parametrize("m,k,n", [(8, 16, 128), (12, 16, 384), (50, 30, 10),
                                   (200, 784, 200)])
def test_relational_matmul_kernel(cuda, m, k, n):
    """Held against the plain version in float64: a float32 oracle sums up
    to 784 products with ``index_add_``'s atomics, in an order that changes
    from run to run, so where they cancel to near 0 its own rounding can
    exceed the float32 tolerance."""
    rng = np.random.RandomState(m)
    rel = RelTensor.from_dense(rnd(rng, m, k, device=cuda))
    b = rnd(rng, k, n, device=cuda)

    def oracle(r, rhs, rows):
        return relmm_mod.plain(r.i, r.j, r.v.double(), rhs.double(),
                               rows).float()

    before = relmm_mod.relational_matmul.launches
    got = ops.relational_matmul(rel.i, rel.j, rel.v, b, m)
    assert relmm_mod.relational_matmul.launches == before + 1
    torch.testing.assert_close(got, oracle(rel, b, m), **F32)
    rel_t = rel.transpose()                     # the backward layout
    c = rnd(rng, m, n, device=cuda)
    torch.testing.assert_close(
        ops.relational_matmul(rel_t.i, rel_t.j, rel_t.v, c, k),
        oracle(rel_t, c, k), **F32)


@pytest.mark.parametrize("nnz,pad", [(32, 0), (48, 16), (8, 56)])
def test_relational_matmul_kernel_padding(cuda, nnz, pad):
    rng = np.random.RandomState(nnz)
    m, k, n = 16, 32, 128
    rows = np.concatenate([np.sort(rng.randint(0, m, nnz)), np.full(pad, m)])
    args = (torch.tensor(rows, dtype=torch.int32, device=cuda),
            torch.tensor(rng.randint(0, k, nnz + pad), dtype=torch.int32,
                         device=cuda),
            rnd(rng, nnz + pad, device=cuda), rnd(rng, k, n, device=cuda), m)
    torch.testing.assert_close(relmm_mod.relational_matmul(*args),
                               relmm_mod.plain(*args), **F32)


def test_relational_matmul_kernel_sorts_unsorted(cuda):
    """Rows out of order (padding included) give the plain version's
    result; an id out of range still raises."""
    rng = np.random.RandomState(5)
    m, k, n = 16, 32, 130
    rows = np.concatenate([rng.randint(0, m, 200), np.full(20, m)])
    order = rng.permutation(rows.size)
    args = (torch.tensor(rows[order], dtype=torch.int32, device=cuda),
            torch.tensor(rng.randint(0, k, rows.size), dtype=torch.int32,
                         device=cuda),
            rnd(rng, rows.size, device=cuda), rnd(rng, k, n, device=cuda), m)
    torch.testing.assert_close(relmm_mod.relational_matmul(*args),
                               relmm_mod.plain(*args), **F32)
    bad = (args[0].flip(0) + m + 1,) + args[1:]
    with pytest.raises(ValueError, match="outside"):
        relmm_mod.relational_matmul(*bad)


def relation(rng, m, k, nnz, pad, device):
    """A sorted relation of ``nnz`` tuples on the even rows of 0..m-1 (the
    odd rows stay empty) and ``pad`` padding tuples (row m) last."""
    rows = np.concatenate([np.sort(rng.randint(0, (m + 1) // 2, nnz) * 2),
                           np.full(pad, m)])
    return (torch.tensor(rows, dtype=torch.int32, device=device),
            torch.tensor(rng.randint(0, k, nnz + pad), dtype=torch.int32,
                         device=device),
            rnd(rng, nnz + pad, device=device))


def oracle(rows, cols, vals, b, m):
    """The plain version in float64: a float32 one sums with index_add_'s
    atomics in an order that changes from run to run."""
    return relmm_mod.plain(rows, cols, vals.double(), b.double(), m).float()


# Each schedule at its edges: the widest k a 4-column slab takes and one row
# of b more; n = 3 / 10 / 200 / 384 in both (one value a load where n is no
# multiple of 16 bytes in the stream, ragged slab tiles); segments of 2000
# tuples (16 warps share a row).  Rows m, k, n, tuples, schedule.
RELMM_EDGES = [
    (64, 13504, 3, 14000, "slab"), (64, 13505, 3, 14000, "stream"),
    (40, 300, 3, 4000, "slab"), (40, 300, 10, 4000, "slab"),
    (40, 300, 200, 4000, "slab"), (40, 300, 384, 4000, "slab"),
    (40, 5000, 3, 2000, "stream"), (40, 5000, 10, 2000, "stream"),
    (40, 5000, 200, 2000, "stream"), (40, 5000, 384, 2000, "stream"),
    (8, 1000, 10, 16000, "slab")]


@pytest.mark.parametrize("m,k,n,nnz,kind", RELMM_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relational_matmul_schedules_at_their_edges(cuda, m, k, n, nnz, kind,
                                                    dtype):
    """Empty rows and padding, held against the float64 plain version; two
    runs give equal bits, and so does the relation in shuffled order,
    which the wrapper sorts first, within the float32 tolerance."""
    rng = np.random.RandomState(m + k + n)
    rows, cols, vals = relation(rng, m, k, nnz, 16, cuda)
    b = rnd(rng, k, n, device=cuda, dtype=dtype)
    assert relmm_mod.schedule(m, k, n, nnz + 16, dtype).kind == kind
    got = relmm_mod.relational_matmul(rows, cols, vals, b, m)
    want = oracle(rows, cols, vals, b, m)
    torch.testing.assert_close(got, want, **F32)
    assert torch.equal(got, relmm_mod.relational_matmul(rows, cols, vals, b,
                                                        m))
    order = torch.tensor(rng.permutation(nnz + 16), device=cuda)
    torch.testing.assert_close(relmm_mod.relational_matmul(
        rows[order], cols[order], vals[order], b, m), want, **F32)


@pytest.mark.parametrize("m,k,n,nnz,kind", RELMM_EDGES[2:])
def test_relational_matmul_bf16_b_is_its_float32_widening(cuda, m, k, n, nnz,
                                                         kind):
    rng = np.random.RandomState(n)
    rows, cols, vals = relation(rng, m, k, nnz, 4, cuda)
    b16 = rnd(rng, k, n, device=cuda, dtype=torch.bfloat16)
    got = relmm_mod.relational_matmul(rows, cols, vals, b16, m)
    assert got.dtype == torch.float32
    assert torch.equal(got, relmm_mod.relational_matmul(rows, cols, vals,
                                                        b16.float(), m))


def sorted_relation(rng, m, k, per_row, pad, device):
    """A relation whose even rows of 0..m-1 hold ``per_row`` distinct cols
    each, in increasing order (the odd rows stay empty), and ``pad``
    padding tuples (row m) last: the order the engines build.  Its values
    are small whole numbers, so that every sum of thousands of products is
    exact in float32 in any order: the result must equal the float64 one
    bit for bit (with random normal values a float32 sum of 3000 products
    is off by about 1e-4, which the per-element tolerance of the reference's
    test misses where a sum falls near 0)."""
    live = range(0, m, 2)
    rows = np.concatenate([np.repeat(np.array(live), per_row),
                           np.full(pad, m)])
    cols = np.concatenate([np.sort(rng.choice(k, per_row, replace=False))
                           for _ in live] + [rng.randint(0, k, pad)])
    return (torch.tensor(rows, dtype=torch.int32, device=device),
            torch.tensor(cols, dtype=torch.int32, device=device),
            whole(rng, rows.size, device=device))


def whole(rng, *shape, device, dtype=torch.float32):
    """Whole numbers in -3..3, exact in bf16 too."""
    return torch.tensor(rng.randint(-3, 4, shape), dtype=torch.float32,
                        device=device).to(dtype)


def routes(fn):
    """``fn()`` and the routes its ``relational_matmul`` calls took."""
    with obs.use(obs.Tracer()) as tr:
        out = fn()
    counts = tr.counters
    calls = counts.pop("relmm.calls", 0)
    assert sum(counts.values()) == calls
    return out, counts


# The long-segment schedule at its edges: the first k past the widest
# 4-column slab, ragged k-ranges (k prime), n = 3 / 10 / 200 / 384 (no
# 16-byte copies at 3 and 10, ragged tiles, two tiles at 384), fewer rows
# than a block's 16 warps, empty rows and padding.  Rows m, k, n, cols a
# live row.
KSLAB_EDGES = [(40, 13505, 3, 2700), (40, 20011, 10, 3000),
               (40, 20011, 200, 3000), (40, 20011, 384, 3000),
               (3, 60000, 10, 4000), (50, 30011, 200, 4000)]


@pytest.mark.parametrize("m,k,n,per_row", KSLAB_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relational_matmul_kslab_at_its_edges(cuda, m, k, n, per_row, dtype):
    """Rows whose cols are sorted take ``kslab`` and give the float64 plain
    version's result exactly (whole numbers: ``sorted_relation``); two runs
    give equal bits; the relation in shuffled order, which the wrapper
    sorts by row (its cols then out of order), takes the stream and gives
    the same."""
    rng = np.random.RandomState(m + k + n)
    rows, cols, vals = sorted_relation(rng, m, k, per_row, 16, cuda)
    b = whole(rng, k, n, device=cuda, dtype=dtype)
    assert relmm_mod.schedule(m, k, n, rows.numel(), dtype).kind == "kslab"
    got, taken = routes(lambda: relmm_mod.relational_matmul(rows, cols, vals,
                                                            b, m))
    assert taken == {"relmm.kslab": 1}
    want = oracle(rows, cols, vals, b, m)
    assert torch.equal(got, want)
    assert torch.equal(got, relmm_mod.relational_matmul(rows, cols, vals, b,
                                                        m))
    order = torch.tensor(rng.permutation(rows.numel()), device=cuda)
    shuffled, taken = routes(lambda: relmm_mod.relational_matmul(
        rows[order], cols[order], vals[order], b, m))
    assert taken == {"relmm.stream": 1}
    assert torch.equal(shuffled, want)


@pytest.mark.parametrize("m,k,n,per_row", KSLAB_EDGES)
def test_relational_matmul_kslab_bf16_b_is_its_float32_widening(
        cuda, m, k, n, per_row):
    """Random normal b, rounded to bf16: the float32 sums of its widened
    values, in the schedule's fixed order, give the same bits as the
    widening itself."""
    rng = np.random.RandomState(n + 1)
    rows, cols, vals = sorted_relation(rng, m, k, per_row, 4, cuda)
    b16 = rnd(rng, k, n, device=cuda, dtype=torch.bfloat16)
    got, taken = routes(lambda: relmm_mod.relational_matmul(rows, cols, vals,
                                                            b16, m))
    assert taken == {"relmm.kslab": 1}
    assert torch.equal(got, relmm_mod.relational_matmul(rows, cols, vals,
                                                        b16.float(), m))


@pytest.mark.parametrize("n", [10, 200])
def test_relational_matmul_unsorted_cols_keep_the_stream(cuda, n):
    """One row with two cols out of order, rows still sorted: the first
    pass's third bit sends the call to the stream, which is right; the
    sorted relation takes ``kslab`` and agrees (exactly: whole numbers)."""
    rng = np.random.RandomState(n)
    m, k = 40, 20011
    rows, cols, vals = sorted_relation(rng, m, k, 3000, 16, cuda)
    b = whole(rng, k, n, device=cuda)
    swapped = cols.clone()
    swapped[[7, 8]] = cols[[8, 7]]
    got, taken = routes(lambda: relmm_mod.relational_matmul(rows, swapped,
                                                            vals, b, m))
    assert taken == {"relmm.stream": 1}
    assert torch.equal(got, oracle(rows, swapped, vals, b, m))
    kslab, taken = routes(lambda: relmm_mod.relational_matmul(rows, cols,
                                                              vals, b, m))
    assert taken == {"relmm.kslab": 1}
    assert torch.equal(kslab, oracle(rows, cols, vals, b, m))


def test_relational_mlp_past_the_slab_edge_takes_kslab(cuda):
    """The MLP at 16,000 rows, the smallest round size past the 13,504 rows
    a 4-column slab of b holds: one relational iteration, under the
    profiler, counts 5 ``relational_matmul`` calls, 2 of them ``kslab``
    (Eqs. 10 and 11), and its mean gradient agrees with the dense
    engine's on the card."""
    from torch.profiler import ProfilerActivity, profile
    rows, lr = 16000, 1e-5
    spec = nn2sql.MLPSpec(rows, 784, 200, 10, lr=lr)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(rows, 784, generator=gen, device=cuda)
    labels = torch.randint(0, 10, (rows,), generator=gen, device=cuda)
    y = torch.nn.functional.one_hot(labels, 10).float()
    graph = nn2sql.build_graph(spec)
    w = nn2sql.init_weights(spec, device=cuda)
    engine = Engine("relational", device=cuda)
    nn2sql.train(graph, w, x, y, 1, engine)             # warm: builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        w_rel, _ = nn2sql.train(graph, w, x, y, 1, engine)
        torch.cuda.synchronize()
    counts = obs.profiled().counters
    assert (counts.get("relmm.kslab"), counts.get("relmm.calls")) == (2, 5)
    assert counts.get("relmm.slab") == 2 and counts.get("relmm.stream") == 1
    w_dense, _ = nn2sql.train(graph, w, x, y, 1, Engine("dense", device=cuda))
    for leaf in w:
        g_rel = (w[leaf] - w_rel[leaf]).double() / lr
        g_dense = (w[leaf] - w_dense[leaf]).double() / lr
        torch.testing.assert_close(g_rel, g_dense, rtol=1e-3,
                                   atol=1e-3 * float(g_dense.abs().max()))


def test_relational_matmul_kernel_raises_and_then_runs_clean(cuda):
    """A row past m, a negative row and a col past k each raise; the call
    after a bad one is right (the status flags were cleared)."""
    rng = np.random.RandomState(11)
    m, k, n = 16, 32, 64
    rows, cols, vals = relation(rng, m, k, 200, 8, cuda)
    b = rnd(rng, k, n, device=cuda)
    bad_rows = rows.clone()
    bad_rows[-1] = m + 1
    neg_rows = rows.clone()
    neg_rows[0] = -1
    for args in ((bad_rows, cols, vals), (neg_rows, cols, vals),
                 (rows, cols + k, vals)):
        with pytest.raises(ValueError, match="outside"):
            relmm_mod.relational_matmul(*args, b, m)
        torch.testing.assert_close(
            relmm_mod.relational_matmul(rows, cols, vals, b, m),
            oracle(rows, cols, vals, b, m), **F32)


# The sweep, both main-path shapes, and the edges of the two tile instances
# (wide 40 x 40 with K slices of 32, narrow 16 x 16 with slices of 64): n
# one below and one above each tile width, k not a multiple of a slice (and
# not of 4, which takes 4-byte copies), m not a multiple of a tile's rows.
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 256),
                                   (150, 4, 3), (2000, 200, 10),
                                   (2000, 784, 200), (81, 100, 39),
                                   (79, 100, 41), (150, 70, 15),
                                   (17, 65, 16), (33, 30, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sigmoid_matmul_kernel(cuda, m, k, n, dtype):
    rng = np.random.RandomState(k)
    x, w = rnd(rng, m, k, device=cuda, dtype=dtype), rnd(rng, k, n,
                                                        device=cuda, dtype=dtype)
    got = ops.fused_sigmoid_matmul(x, w)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), fsm_mod.plain(x, w).float(),
                               **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("m,k,n", [(2000, 784, 200), (2000, 200, 10)])
def test_fused_sigmoid_matmul_kernel_is_deterministic(cuda, m, k, n):
    """The K groups' partial sums meet in a fixed order: two calls give
    the same bits."""
    rng = np.random.RandomState(n)
    x, w = rnd(rng, m, k, device=cuda), rnd(rng, k, n, device=cuda)
    assert torch.equal(fsm_mod.fused_sigmoid_matmul(x, w),
                       fsm_mod.fused_sigmoid_matmul(x, w))


@pytest.mark.parametrize("t,v,d", [(16, 100, 64), (128, 333, 256), (7, 5, 3),
                                   (2000, 10, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_embed_kernel(cuda, t, v, d, dtype):
    rng = np.random.RandomState(t)
    ids = torch.tensor(rng.randint(0, v, t), dtype=torch.int32, device=cuda)
    table = rnd(rng, v, d, device=cuda, dtype=dtype)
    assert torch.equal(ops.onehot_embed(ids, table), embed_mod.plain(ids, table))


def test_onehot_embed_kernel_bounds_checks(cuda):
    with pytest.raises(IndexError):
        embed_mod.onehot_embed(torch.tensor([0, 3], dtype=torch.int32,
                                            device=cuda),
                               torch.eye(3, device=cuda))


def test_onehot_embed_kernel_good_call_after_a_bad_one(cuda):
    """The status flag is cleared once read: a call after one that raised
    returns the plain version's rows and does not raise; one launch a
    call, the raising one included."""
    table = rnd(np.random.RandomState(1), 11, 10, device=cuda)
    good = torch.tensor([0, 10, 3, 3, 7], dtype=torch.int32, device=cuda)
    before = embed_mod.onehot_embed.launches
    with pytest.raises(IndexError):
        embed_mod.onehot_embed(torch.tensor([0, 11], dtype=torch.int32,
                                            device=cuda), table)
    for _ in range(2):
        assert torch.equal(embed_mod.onehot_embed(good, table),
                           embed_mod.plain(good, table))
    with pytest.raises(IndexError):
        embed_mod.onehot_embed(torch.tensor([-1], dtype=torch.int32,
                                            device=cuda), table)
    assert torch.equal(embed_mod.onehot_embed(good, table),
                       embed_mod.plain(good, table))
    assert embed_mod.onehot_embed.launches == before + 5


def test_onehot_embed_kernel_threads_read_their_own_flag(cuda):
    """Threads calling at once share the device's status flag (the C
    launcher holds the device's lock from the launch to the clear, and
    ctypes lets the threads into it together): every bad call raises and
    every good one returns the plain version's rows."""
    table = rnd(np.random.RandomState(2), 11, 10, device=cuda)
    good = torch.tensor(np.random.RandomState(3).randint(0, 11, 2000),
                        dtype=torch.int32, device=cuda)
    bad = good.clone()
    bad[1234] = 11
    want = embed_mod.plain(good, table)
    errors = []

    def worker(i):
        try:
            for r in range(30):
                if (i + r) % 3 == 0:
                    with pytest.raises(IndexError):
                        embed_mod.onehot_embed(bad, table)
                elif not torch.equal(embed_mod.onehot_embed(good, table),
                                     want):
                    errors.append(f"thread {i}, call {r}: wrong rows")
        except (Exception, pytest.fail.Exception) as e:   # reported below
            errors.append(f"thread {i}: {e!r}")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]


@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                                         (1, 8, 1, 256, 128), (1, 4, 2, 77, 32),
                                         (2, 4, 2, 1000, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, b, hq, hkv, s, d, causal, dtype):
    rng = np.random.RandomState(s + d)
    q = rnd(rng, b, hq, s, d, device=cuda, dtype=dtype)
    k = rnd(rng, b, hkv, s, d, device=cuda, dtype=dtype)
    v = rnd(rng, b, hkv, s, d, device=cuda, dtype=dtype)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_mod.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, causal=causal).float(),
        **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.parametrize("b,hq,hkv,s,d,dv", [(1, 4, 4, 77, 64, 32),
                                            (2, 4, 2, 130, 128, 64),
                                            (1, 4, 4, 100, 192, 128),
                                            (1, 2, 2, 65, 192, 32),
                                            (2, 4, 4, 2000, 192, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_v_head_dim(cuda, b, hq, hkv, s, d, dv, causal,
                                           dtype):
    """v narrower than q/k (MLA: 192 / 128), ragged S; scale D ** -0.5."""
    rng = np.random.RandomState(s + d + dv)
    q = rnd(rng, b, hq, s, d, device=cuda, dtype=dtype)
    k = rnd(rng, b, hkv, s, d, device=cuda, dtype=dtype)
    v = rnd(rng, b, hkv, s, dv, device=cuda, dtype=dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, hq, s, dv)
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, causal=causal).float(),
        **(F32 if dtype == torch.float32 else BF16))


def test_flash_attention_kernel_takes_head_split_views(cuda):
    """The model hands over (B, S, H, D) projections viewed as (B, H, S, D)."""
    rng = np.random.RandomState(0)
    q = rnd(rng, 2, 100, 4, 32, device=cuda).transpose(1, 2)
    k = rnd(rng, 2, 100, 2, 32, device=cuda).transpose(1, 2)
    v = rnd(rng, 2, 100, 2, 32, device=cuda).transpose(1, 2)
    torch.testing.assert_close(flash_mod.flash_attention(q, k, v),
                               flash_mod.plain(q, k, v), **F32)


# bf16 against bf16_scores=True: both round P to bf16 and sum the rounded
# values, so they differ where the kernel's running max is not yet the
# row's max (P rounded at another scale, one bf16 ulp, 2^-8 of the value)
# and in the order of the float32 sums, then by the output's rounding (one
# bf16 ulp): 1e-2 holds that and is 3x tighter than BF16's atol.
TC_SCORES = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d,dv", flash_mod.head_dims(torch.bfloat16))
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 2000])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tc_kernel(cuda, d, dv, s, group, causal):
    """The bf16 tensor-core kernel over every head-dim pair, the tile edges
    of S (128-row query and key tiles) and a ragged long S, one KV head per
    query head and eight, against both plain versions; one launch a call."""
    rng = np.random.RandomState(d + dv + s + group)
    hkv = 2
    q = rnd(rng, 1, hkv * group, s, d, device=cuda, dtype=torch.bfloat16)
    k = rnd(rng, 1, hkv, s, d, device=cuda, dtype=torch.bfloat16)
    v = rnd(rng, 1, hkv, s, dv, device=cuda, dtype=torch.bfloat16)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_mod.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (1, hkv * group, s,
                                                         dv)
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, causal=causal).float(), **BF16)
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, causal=causal,
                                     bf16_scores=True).float(), **TC_SCORES)


@pytest.mark.parametrize("d,dv", [(32, 32), (80, 80), (128, 128), (192, 128)])
def test_flash_attention_tc_kernel_takes_head_split_views(cuda, d, dv):
    """bf16 (B, S, H, D) projections viewed as (B, H, S, D): the tensor maps
    take their strides, nothing is copied."""
    rng = np.random.RandomState(d + dv)
    q = rnd(rng, 2, 100, 8, d, device=cuda, dtype=torch.bfloat16)
    k = rnd(rng, 2, 100, 2, d, device=cuda, dtype=torch.bfloat16)
    v = rnd(rng, 2, 100, 2, dv, device=cuda, dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    assert all(flash_mod.takes(t) for t in (q, k, v))
    got = flash_mod.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(),
                               flash_mod.plain(q, k, v).float(), **BF16)
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, bf16_scores=True).float(),
        **TC_SCORES)


def test_flash_attention_tc_kernel_copies_what_tma_cannot_read(cuda):
    """A base off 16 bytes, or a sequence stride of 68 elements (136 bytes),
    is refused by the kernel's wrapper and copied by ops."""
    rng = np.random.RandomState(3)
    buf = rnd(rng, 1, 4, 77, 68, device=cuda, dtype=torch.bfloat16)
    q = buf[..., 1:65]                          # base 2 bytes off
    k = buf[:, :2, :, :64]                      # sequence stride 68
    v = rnd(rng, 1, 2, 77, 64, device=cuda, dtype=torch.bfloat16)
    assert not flash_mod.takes(q) and not flash_mod.takes(k)
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.flash_attention(q, k, v)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert flash_mod.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, bf16_scores=True).float(),
        **TC_SCORES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bf16_scores_on_the_card(cuda, dtype):
    """``bf16_scores`` runs the bf16 kernel (float32 operands cast there and
    back) and matches its plain version."""
    rng = np.random.RandomState(5)
    q = rnd(rng, 2, 8, 150, 64, device=cuda, dtype=dtype)
    k = rnd(rng, 2, 2, 150, 64, device=cuda, dtype=dtype)
    v = rnd(rng, 2, 2, 150, 64, device=cuda, dtype=dtype)
    got = ops.flash_attention(q, k, v, bf16_scores=True)
    assert got.dtype == dtype
    torch.testing.assert_close(
        got.float(), flash_mod.plain(q, k, v, bf16_scores=True).float(),
        **TC_SCORES)


@pytest.mark.parametrize("d,dv", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 2000])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_kernel(cuda, d, dv, s, group, causal):
    """The float32 kernel (3xTF32 on the tensor cores) over every head-dim
    pair, the tile edges of S (64-row query and key tiles) and a ragged long
    S, one KV head per query head and eight, at the float32 tolerance; one
    launch a call."""
    rng = np.random.RandomState(d + dv + s + group)
    hkv = 2
    q = rnd(rng, 1, hkv * group, s, d, device=cuda)
    k = rnd(rng, 1, hkv, s, d, device=cuda)
    v = rnd(rng, 1, hkv, s, dv, device=cuda)
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_mod.flash_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (1, hkv * group, s,
                                                        dv)
    torch.testing.assert_close(got, flash_mod.plain(q, k, v, causal=causal),
                               **F32)


def test_flash_attention_f32_kernel_does_not_shrink_its_output(cuda):
    """At Yi-6B's prefill shape the float32 kernel's mean error along the
    sign of the float64 value stays near 0: the tensor cores truncate each
    wgmma's float32 sum, and an accumulator carried through all 32 key
    tiles shrank the output by 4.9e-6 of itself (each tile's P·V is now
    summed apart, PERF.md); the bound sits between that and the emulated
    design's 1.3e-6."""
    rng = np.random.RandomState(0)
    q = rnd(rng, 4, 32, 2000, 128, device=cuda)
    k, v = (rnd(rng, 4, 4, 2000, 128, device=cuda) for _ in range(2))
    got = ops.flash_attention(q, k, v).double()
    exact = ref.flash_attention(q.double(), k.double(), v.double())
    shrink = float(((got - exact) * exact.sign()).mean() / exact.abs().mean())
    assert abs(shrink) < 2.5e-6, shrink


def test_flash_attention_f32_path_at_depth_meets_float64(cuda, monkeypatch):
    """The float32 flash path through 4 full-width Yi-6B layers (random
    weights) and 2 prompts of 2000 tokens: last-token logits within the
    float32 logit tolerance (1e-4, ``chip_smoke.LOGIT_TOL``) of the same
    model in float64 with dense attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM

    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=4)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=cuda).manual_seed(2))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 2000)).astype(np.int32)).to(cuda)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    before = flash_mod.flash_attention.launches
    got = lm.prefill(params, {"tokens": tokens})[0].double()
    assert flash_mod.flash_attention.launches == before + cfg.n_layers

    def wide(tree):
        return {k: wide(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}

    params = wide(params)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float64)
    monkeypatch.setattr(layers, "ACCUM_DTYPE", torch.float64)
    dense = LM(dataclasses.replace(cfg, attn_impl="dense"))
    exact = dense.prefill(params, {"tokens": tokens})[0]
    torch.testing.assert_close(got, exact, rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("d,dv", [(32, 32), (80, 80), (128, 128), (192, 128)])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_attention_f32_kernel_takes_head_split_views(cuda, d, dv,
                                                           offset):
    """float32 (B, S, H, D) projections viewed as (B, H, S, D), read in
    place by their strides; with ``offset`` 1 every base is 4 bytes off 16
    (the kernel's 4-byte loads), and nothing is copied either way."""
    rng = np.random.RandomState(d + dv + offset)

    def heads(h, width):
        buf = rnd(rng, 2 * 130 * h * width + offset, device=cuda)
        return buf[offset:].view(2, 130, h, width).transpose(1, 2)

    q, k, v = heads(8, d), heads(2, d), heads(2, dv)
    assert all(flash_mod.takes(t) for t in (q, k, v))
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    for causal in (True, False):
        torch.testing.assert_close(
            flash_mod.flash_attention(q, k, v, causal=causal),
            flash_mod.plain(q, k, v, causal=causal), **F32)


# Zamba2-2.7B's shared attention at its prefill shape: B = 4, 32 heads of
# 80 (MHA), S = 2048, causal, scale 80 ** -0.5, as the model's head-split
# views of its (B, S, 2560) projections
ZAMBA2 = (4, 32, 2048, 80)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_zamba2s_shape(cuda, dtype):
    """Both kernels at (80, 80), padded on chip to whole slabs, against the
    plain version at the full Zamba2 shape; bf16 also against the
    bf16-scores plain version, whose numerics the kernel has."""
    b, h, s, d = ZAMBA2
    rng = np.random.RandomState(80)
    q, k, v = (rnd(rng, b, s, h, d, device=cuda, dtype=dtype).transpose(1, 2)
               for _ in range(3))
    assert all(flash_mod.takes(t) for t in (q, k, v))
    before = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert flash_mod.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    want = flash_mod.plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16)
        torch.testing.assert_close(
            got.float(), flash_mod.plain(q, k, v, bf16_scores=True).float(),
            **TC_SCORES)


def test_flash_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention(q, q, q)


@pytest.mark.parametrize("t,slots,d", [(32, 64, 64), (64, 96, 128),
                                      (8000, 60416, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_kernel(cuda, t, slots, d, dtype):
    """tests/test_kernels.py's shapes and DeepSeek-V2-Lite's prefill bucket
    fill (8000 tokens into 64 x 944 slots), equal bit for bit."""
    rng = np.random.RandomState(t)
    x = rnd(rng, t, d, device=cuda, dtype=dtype)
    idx = torch.tensor(rng.randint(0, t, slots), dtype=torch.int32,
                       device=cuda)
    gates = torch.tensor(rng.rand(slots), dtype=torch.float32, device=cuda)
    gates[::7] = 0.0                            # the empty slots' gate
    before = moe_mod.moe_dispatch.launches
    got = ops.moe_dispatch(x, idx, gates)
    assert moe_mod.moe_dispatch.launches == before + 1
    assert got.dtype == dtype and got.shape == (slots, d)
    assert torch.equal(got, moe_mod.plain(x, idx, gates))


def test_moe_dispatch_kernel_refusals(cuda):
    x = torch.ones(4, 16, device=cuda)
    gates = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        moe_mod.moe_dispatch(x, torch.tensor([0, 4, 1], dtype=torch.int32,
                                             device=cuda), gates)
    with pytest.raises(ValueError, match="outside"):
        moe_mod.moe_dispatch(x, torch.tensor([0, -1, 1], dtype=torch.int32,
                                             device=cuda), gates)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_mod.moe_dispatch(torch.ones(4, 12, device=cuda), idx, gates)
    with pytest.raises(TypeError):
        moe_mod.moe_dispatch(x.double(), idx, gates)
    assert moe_mod.moe_dispatch(x, idx[:0], gates[:0]).shape == (0, 16)


def test_moe_dispatch_kernel_good_call_after_a_bad_one(cuda):
    """The status flag is cleared after the call that raised it."""
    rng = np.random.RandomState(12)
    x = rnd(rng, 50, 64, device=cuda, dtype=torch.bfloat16)
    idx = torch.tensor(rng.randint(0, 50, 300), dtype=torch.int32,
                       device=cuda)
    gates = torch.tensor(rng.rand(300), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        moe_mod.moe_dispatch(x, idx + 50, gates)
    for _ in range(2):
        assert torch.equal(moe_mod.moe_dispatch(x, idx, gates),
                           moe_mod.plain(x, idx, gates))


def test_moe_combine_on_the_card_is_the_plain_version(cuda):
    rng = np.random.RandomState(9)
    ys = rnd(rng, 40, 64, device=cuda)
    rows = torch.tensor(np.sort(rng.randint(0, 12, 40)), dtype=torch.int32,
                        device=cuda)
    before = relmm_mod.relational_matmul.launches
    got = ops.moe_combine(ys, rows, 12)
    assert relmm_mod.relational_matmul.launches == before + 1
    torch.testing.assert_close(got, ops.ref.moe_combine(ys, rows, 12), **F32)


def test_moe_combine_on_the_card_takes_bf16_rows(cuda):
    """bf16 slot rows go to the kernel as they are and give the bits of
    their float32 copy's combine, cast back to bf16."""
    rng = np.random.RandomState(10)
    ys = rnd(rng, 40, 64, device=cuda, dtype=torch.bfloat16)
    rows = torch.tensor(np.sort(rng.randint(0, 12, 40)), dtype=torch.int32,
                        device=cuda)
    got = ops.moe_combine(ys, rows, 12)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.moe_combine(ys.float(), rows, 12).to(
        torch.bfloat16))


def scan_inputs(rng, lead, s, n, device):
    """tests/test_kernels.py's inputs: w uniform in [0.4, 0.9), s0 =
    0.1·randn."""
    r, k, v = (rnd(rng, *lead, s, n, device=device) for _ in range(3))
    w = torch.tensor(rng.rand(*lead, s, n) * 0.5 + 0.4, dtype=torch.float32,
                     device=device)
    return (r, k, v, w, rnd(rng, *lead, n, device=device),
            rnd(rng, *lead, n, n, device=device) * 0.1)


@pytest.mark.parametrize("bh,s,n", [(2, 32, 16), (4, 64, 32), (1, 128, 64),
                                    (3, 1, 64), (3, 7, 32), (5, 77, 64)])
def test_rwkv6_scan_kernel(cuda, bh, s, n):
    args = scan_inputs(np.random.RandomState(s + n), (bh,), s, n, cuda)
    before = scan_mod.rwkv6_scan.launches
    o, s_fin = ops.rwkv6_scan(*args)
    assert scan_mod.rwkv6_scan.launches == before + 1
    o_ref, s_ref = scan_mod.plain(*args)
    torch.testing.assert_close(o, o_ref, **SCAN)
    torch.testing.assert_close(s_fin, s_ref, **SCAN)


def test_rwkv6_scan_kernel_takes_head_split_views(cuda):
    """The layer hands over (B, S, H, N) projections viewed as (B, H, S, N)
    and u (H, N) expanded over the batch; s0 is left as it was."""
    rng = np.random.RandomState(1)
    b, h, s, n = 2, 3, 40, 64
    r, k, v, w = (t.transpose(1, 2) for t in scan_inputs(
        rng, (b, s), h, n, cuda)[:4])
    u = rnd(rng, h, n, device=cuda).expand(b, h, n)
    s0 = rnd(rng, b, h, n, n, device=cuda)
    s0_before = s0.clone()
    o, s_fin = scan_mod.rwkv6_scan(r, k, v, w, u, s0)
    assert o.shape == r.shape and o.transpose(1, 2).is_contiguous()
    o_ref, s_ref = scan_mod.plain(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, **SCAN)
    torch.testing.assert_close(s_fin, s_ref, **SCAN)
    assert torch.equal(s0, s0_before)


def test_rwkv6_scan_kernel_refusals(cuda):
    r, k, v, w, u, s0 = scan_inputs(np.random.RandomState(2), (2,), 8, 32,
                                    cuda)
    with pytest.raises(TypeError, match="float32"):
        scan_mod.rwkv6_scan(r.to(torch.bfloat16), k, v, w, u, s0)
    with pytest.raises(ValueError, match="takes u"):
        scan_mod.rwkv6_scan(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError):
        scan_mod.rwkv6_scan(r, k[:, :4], v, w, u, s0)
    r, k, v, w, u, s0 = scan_inputs(np.random.RandomState(3), (2,), 8, 48,
                                    cuda)
    with pytest.raises(ValueError, match="head dim"):
        scan_mod.rwkv6_scan(r, k, v, w, u, s0)


@pytest.mark.parametrize("n", scan_mod.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 31, 32, 33, 2000])
@pytest.mark.parametrize("layout", ["dense", "views", "misaligned"])
def test_rwkv6_scan_kernel_time_edges(cuda, n, s, layout):
    """Every head dim over the edges of the 16-step chunks and a long S,
    with u (H, N) expanded over the batch: dense (B, H, S, N) operands, the
    layer's head-split views of (B, S, H, N) projections (16-byte copies),
    and views whose bases sit 4 bytes off 16 (4-byte copies); s0 is left as
    it was."""
    rng = np.random.RandomState(s + n)
    b, h = 2, 3
    r, k, v, w = scan_inputs(rng, (b, s), h, n, cuda)[:4]
    if layout == "dense":
        r, k, v, w = (t.transpose(1, 2).contiguous() for t in (r, k, v, w))
    else:
        if layout == "misaligned":
            r, k, v, w = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                          .view(t.shape) for t in (r, k, v, w))
            assert all(t.data_ptr() % 16 == 4 for t in (r, k, v, w))
        r, k, v, w = (t.transpose(1, 2) for t in (r, k, v, w))
    u = rnd(rng, h, n, device=cuda).expand(b, h, n)
    s0 = rnd(rng, b, h, n, n, device=cuda) * 0.1
    s0_before = s0.clone()
    before = scan_mod.rwkv6_scan.launches
    o, s_fin = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert scan_mod.rwkv6_scan.launches == before + 1
    o_ref, s_ref = scan_mod.plain(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, **SCAN)
    torch.testing.assert_close(s_fin, s_ref, **SCAN)
    assert torch.equal(s0, s0_before)


# ---------------------------------------------------------------------------
# rwkv6_scan_bwd: the recurrence's gradient against the plain backward in
# float64 on the card
# ---------------------------------------------------------------------------

BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def scan_bwd_oracle(args, do, ds_fin):
    return scan_mod.plain_bwd(*(t.double() for t in args), do.double(),
                              None if ds_fin is None else ds_fin.double())


def check_scan_bwd(got, want):
    for name, g, w in zip(BWD_NAMES, got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w.float(), msg=name, **SCAN)


@pytest.mark.parametrize("bh,s,n", [(2, 32, 16), (4, 64, 32), (1, 128, 64),
                                    (3, 1, 64), (3, 7, 32), (5, 77, 64)])
@pytest.mark.parametrize("with_ds_fin", [False, True])
def test_rwkv6_scan_bwd_kernel(cuda, bh, s, n, with_ds_fin):
    """The forward's shape list as the JAX kernel takes it, (BH, S, N),
    with a zero (None) and a nonzero ds_fin."""
    rng = np.random.RandomState(7 * s + n)
    args = scan_inputs(rng, (bh,), s, n, cuda)
    do = rnd(rng, bh, s, n, device=cuda)
    ds_fin = rnd(rng, bh, n, n, device=cuda) if with_ds_fin else None
    before = scan_mod.rwkv6_scan_bwd.launches
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    assert scan_mod.rwkv6_scan_bwd.launches == before + 1
    check_scan_bwd(got, scan_bwd_oracle(args, do, ds_fin))


def layer_views(rng, b, h, s, n, device, layout):
    """r, k, v, w and do as the layer hands them over: dense (B, H, S, N),
    head-split views of (B, S, H, N) (16-byte copies), or such views whose
    bases sit 4 bytes off 16 (4-byte copies); u (H, N) expanded over the
    batch; s0."""
    seq = list(scan_inputs(rng, (b, s), h, n, device)[:4])
    seq.append(rnd(rng, b, s, h, n, device=device))
    if layout == "dense":
        seq = [t.transpose(1, 2).contiguous() for t in seq]
    else:
        if layout == "misaligned":
            seq = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                   .view(t.shape) for t in seq]
            assert all(t.data_ptr() % 16 == 4 for t in seq)
        seq = [t.transpose(1, 2) for t in seq]
    u = rnd(rng, h, n, device=device).expand(b, h, n)
    s0 = rnd(rng, b, h, n, n, device=device) * 0.1
    return (*seq[:4], u, s0), seq[4]


@pytest.mark.parametrize("n", scan_mod.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 7, 8, 9, 17, 2000])
@pytest.mark.parametrize("layout", ["dense", "views", "misaligned"])
def test_rwkv6_scan_bwd_kernel_time_edges(cuda, n, s, layout):
    """Every head dim over the edges of the 16-step sub-chunks (S 1 and 7
    inside one, 17 past it; 2000 walks 32 chunks of 64 and ends in a ragged
    one) in the layer's layouts, a nonzero ds_fin; dr, dk, dv and dw come in
    their operand's memory layout where it is dense, du per row of state,
    and no operand is written."""
    rng = np.random.RandomState(s + 3 * n)
    b, h = 2, 3
    args, do = layer_views(rng, b, h, s, n, cuda, layout)
    ds_fin = rnd(rng, b, h, n, n, device=cuda)
    kept = [t.clone() for t in (*args, do, ds_fin)]
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    check_scan_bwd(got, scan_bwd_oracle(args, do, ds_fin))
    if layout == "views":
        assert all(g.stride() == a.stride() for g, a in zip(got, args[:4]))
    assert got[4].shape == (b, h, n)
    assert all(torch.equal(a, c) for a, c in zip((*args, do, ds_fin), kept))


def test_rwkv6_scan_bwd_kernel_at_the_training_microbatch(cuda):
    """RWKV-6 7B's training microbatch as the layer hands it over, (2, 64,
    4096, 64) head-split views, u expanded, nonzero s0 and ds_fin; two
    calls equal bit for bit."""
    rng = np.random.RandomState(25)
    args, do = layer_views(rng, 2, 64, 4096, 64, cuda, "views")
    ds_fin = rnd(rng, 2, 64, 64, 64, device=cuda)
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    again = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    check_scan_bwd(got, scan_bwd_oracle(args, do, ds_fin))


def test_rwkv6_scan_autograd_on_the_card(cuda):
    """ops.rwkv6_scan records ``_Rwkv6Scan`` on operands that require grad:
    one forward and one backward launch, and the gradient is the kernel's
    (s_fin unused: ds_fin None; s0 needs none: no ds0), u's summed over
    its expand."""
    rng = np.random.RandomState(26)
    b, h, s, n = 2, 4, 100, 64
    (r, k, v, w, u, s0), do = layer_views(rng, b, h, s, n, cuda, "views")
    u_param = u[0].clone().requires_grad_()
    leaves = [t.detach().requires_grad_() for t in (r, k, v, w)]
    f0 = scan_mod.rwkv6_scan.launches
    b0 = scan_mod.rwkv6_scan_bwd.launches
    o, _ = ops.rwkv6_scan(*leaves, u_param.expand(b, h, n), s0)
    got = torch.autograd.grad(o, leaves + [u_param], do)
    assert (scan_mod.rwkv6_scan.launches - f0,
            scan_mod.rwkv6_scan_bwd.launches - b0) == (1, 1)
    want = scan_mod.rwkv6_scan_bwd(r, k, v, w, u, s0, do, None, False)
    assert want[5] is None
    for g, c in zip(got[:4], want[:4]):
        assert torch.equal(g, c)
    assert torch.equal(got[4], want[4].sum(0))


def wide_views(rng, b, h, s, n, device):
    """``layer_views`` with the decay a trained RWKV-6 spreads: w =
    exp(-exp(x)), x uniform in [-6, 5) (exact float32 zeros, values within
    0.003 of 1)."""
    (r, k, v, _, u, s0), do = layer_views(rng, b, h, s, n, device, "views")
    w = torch.tensor(np.exp(-np.exp(rng.uniform(-6, 5, size=(b, s, h, n)))),
                     dtype=torch.float32, device=device).transpose(1, 2)
    return (r, k, v, w, u, s0), do


@pytest.mark.parametrize("n", scan_mod.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 7, 77])
def test_rwkv6_scan_bwd_kernel_with_wide_decays(cuda, n, s):
    """The wide decay against the plain backward in float64 at SCAN_TOL,
    every gradient finite."""
    rng = np.random.RandomState(11 * s + n)
    args, do = wide_views(rng, 2, 3, s, n, cuda)
    ds_fin = rnd(rng, 2, 3, n, n, device=cuda)
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    check_scan_bwd(got, scan_bwd_oracle(args, do, ds_fin))


def test_rwkv6_scan_bwd_kernel_with_wide_decays_at_the_microbatch(cuda):
    """(2, 64, 4096, 64) head-split views with the wide decay (thousands of
    exact zeros in w), nonzero s0 and ds_fin: within SCAN_TOL of float64,
    every gradient finite, two calls equal bit for bit."""
    rng = np.random.RandomState(28)
    args, do = wide_views(rng, 2, 64, 4096, 64, cuda)
    assert int((args[3] == 0).sum()) > 1000
    ds_fin = rnd(rng, 2, 64, 64, 64, device=cuda)
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    again = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    check_scan_bwd(got, scan_bwd_oracle(args, do, ds_fin))


@pytest.mark.parametrize("n", scan_mod.HEAD_DIMS)
@pytest.mark.parametrize("wide", [False, True])
def test_rwkv6_scan_bwd_kernel_is_its_chunked_twin(cuda, n, wide):
    """The kernel against ``ref.rwkv6_scan_bwd_chunked`` (its algebra in
    plain PyTorch) on the same float32 inputs on the card, at SCAN_TOL:
    S 77 walks two chunks and ends in a ragged one."""
    rng = np.random.RandomState(n + wide)
    if wide:
        args, do = wide_views(rng, 2, 3, 77, n, cuda)
    else:
        args, do = layer_views(rng, 2, 3, 77, n, cuda, "views")
    ds_fin = rnd(rng, 2, 3, n, n, device=cuda)
    got = scan_mod.rwkv6_scan_bwd(*args, do, ds_fin)
    want = ref.rwkv6_scan_bwd_chunked(*args, do, ds_fin)
    for name, g, w in zip(BWD_NAMES, got, want, strict=True):
        assert w.dtype == torch.float32
        torch.testing.assert_close(g, w, msg=name, **SCAN)


def test_rwkv6_scan_bwd_kernel_counts_one_launch_a_call(cuda):
    """``rwkv6_scan_bwd.launches`` adds one a call, whatever the call (its
    three kernels are one launch of the wrapper), and none for a refusal."""
    rng = np.random.RandomState(29)
    args, do = layer_views(rng, 1, 2, 9, 16, cuda, "views")
    before = scan_mod.rwkv6_scan_bwd.launches
    scan_mod.rwkv6_scan_bwd(*args, do)
    scan_mod.rwkv6_scan_bwd(*args, do, None, False)
    assert scan_mod.rwkv6_scan_bwd.launches == before + 2
    with pytest.raises(TypeError):
        scan_mod.rwkv6_scan_bwd(*args, do.double())
    assert scan_mod.rwkv6_scan_bwd.launches == before + 2


def test_rwkv6_scan_bwd_kernel_refusals(cuda):
    r, k, v, w, u, s0 = scan_inputs(np.random.RandomState(27), (2,), 8, 32,
                                    cuda)
    do = torch.ones_like(r)
    with pytest.raises(TypeError, match="float32"):
        scan_mod.rwkv6_scan_bwd(r, k, v, w, u, s0, do.to(torch.bfloat16))
    with pytest.raises(ValueError, match="of one shape"):
        scan_mod.rwkv6_scan_bwd(r, k, v, w, u, s0, do[:, :4])
    with pytest.raises(ValueError, match="ds_fin"):
        scan_mod.rwkv6_scan_bwd(r, k, v, w, u, s0, do, s0[:1])
    with pytest.raises(ValueError, match="unit stride"):
        scan_mod.rwkv6_scan_bwd(r, k, v, w, u, s0, do.transpose(1, 2)
                                .contiguous().transpose(1, 2))


# ---------------------------------------------------------------------------
# the DAG zoo in SQL against the kernels (chip_smoke.py phase 10 (c))
# ---------------------------------------------------------------------------

ZOO_TOL = 1e-4                                   # tests/test_zoo_db.py


def _slots(rng, t, slots):
    return rng.randint(0, t, slots).astype(np.int32), \
        rng.rand(slots).astype(np.float32)


def test_zoo_dispatch_in_sql_equals_moe_dispatch_kernel(cuda):
    from repro_torch.db import zoo
    from repro_torch.db.sql_engine import SQLEngine

    rng = np.random.RandomState(0)
    t, d, slots = 16, 64, 96
    x = rng.randn(t, d).astype(np.float32)
    tok, gate = _slots(rng, t, slots)
    out, _, _, _ = zoo.moe_dispatch_graph(t, d, slots)
    with SQLEngine(dialect="array", plan_cache_=False) as eng:
        sql, = eng.evaluate([out], {
            "x": x, "slot_token": tok.astype(np.float64).reshape(-1, 1),
            "slot_gate": gate.reshape(-1, 1)})
    before = moe_mod.moe_dispatch.launches
    card = ops.moe_dispatch(torch.from_numpy(x).to(cuda),
                            torch.from_numpy(tok).to(cuda),
                            torch.from_numpy(gate).to(cuda))
    assert moe_mod.moe_dispatch.launches == before + 1
    np.testing.assert_allclose(card.cpu().numpy(), sql, rtol=0, atol=ZOO_TOL)


def test_zoo_combine_in_sql_equals_relational_matmul_kernel(cuda):
    from repro_torch.db import zoo
    from repro_torch.db.sql_engine import SQLEngine

    rng = np.random.RandomState(1)
    t, d, slots = 16, 64, 96
    tok, _ = _slots(rng, t, slots)
    y = rng.randn(slots, d).astype(np.float32)
    out, _, _ = zoo.moe_combine_graph(slots, d, t)
    with SQLEngine(dialect="array", plan_cache_=False) as eng:
        sql, = eng.evaluate([out], {
            "expert_out": y,
            "slot_token": tok.astype(np.float64).reshape(-1, 1)})
    before = relmm_mod.relational_matmul.launches
    card = ops.moe_combine(torch.from_numpy(y).to(cuda),
                           torch.from_numpy(tok).to(cuda), t)
    assert relmm_mod.relational_matmul.launches == before + 1
    np.testing.assert_allclose(card.cpu().numpy(), sql, rtol=0, atol=ZOO_TOL)


def test_zoo_rwkv6_time_mix_in_sql_equals_rwkv6_scan_kernel(cuda):
    from repro_torch.db import zoo
    from repro_torch.db.sql_engine import SQLEngine

    rng = np.random.RandomState(2)
    s, n = 8, 16
    r, k, v = (rng.randn(s, n).astype(np.float32) * 0.5 for _ in range(3))
    w = (rng.rand(s, n) * 0.5 + 0.3).astype(np.float32)
    u = (rng.randn(n) * 0.5).astype(np.float32)
    s0 = (rng.randn(n, n) * 0.3).astype(np.float32)
    with SQLEngine(dialect="array", plan_cache_=False) as eng:
        o_sql, sfin_sql = zoo.run_rwkv6_in_db(r, k, v, w, u, s0, engine=eng)
    before = scan_mod.rwkv6_scan.launches
    o, sfin = ops.rwkv6_scan(*(torch.from_numpy(a)[None].to(cuda)
                               for a in (r, k, v, w, u, s0)))
    assert scan_mod.rwkv6_scan.launches == before + 1
    np.testing.assert_allclose(o[0].cpu().numpy(), o_sql, rtol=0,
                               atol=ZOO_TOL)
    np.testing.assert_allclose(sfin[0].cpu().numpy(), sfin_sql, rtol=0,
                               atol=ZOO_TOL)


# ---------------------------------------------------------------------------
# flash_attention_bwd: the gradient kernel against its plain version, whose
# oracle runs in float64 on the same inputs (the kernel sums in float32: up
# to group x S products a dK entry, in another order).  float32 at F32;
# bf16 operands are widened exactly and the gradients rounded once to bf16,
# so at most one bf16 ulp (2^-7 of the rounded value) beyond F32: BF16_BWD
# (chip_smoke.py's BF16_BWD_TOL).
# ---------------------------------------------------------------------------

BF16_BWD = dict(rtol=8.1e-3, atol=2.1e-5)


def bwd_inputs(rng, b, hq, hkv, s, d, dv, device, dtype):
    q = rnd(rng, b, hq, s, d, device=device, dtype=dtype)
    k = rnd(rng, b, hkv, s, d, device=device, dtype=dtype)
    v = rnd(rng, b, hkv, s, dv, device=device, dtype=dtype)
    do = rnd(rng, b, hq, s, dv, device=device, dtype=dtype)
    return q, k, v, do


def bwd_oracle(q, k, v, do, causal):
    return [g.to(t.dtype) for g, t in zip(flash_mod.plain_bwd(
        *(t.double() for t in (q, k, v, do)), causal=causal), (q, k, v))]


@pytest.mark.parametrize("d,dv", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel(cuda, d, dv, s, group, causal, dtype):
    """Every head-dim pair, the 64-row tile edges and a ragged S, one and
    four query heads a KV head, both types; one count a call."""
    rng = np.random.RandomState(d + dv + s + group)
    q, k, v, do = bwd_inputs(rng, 2, 2 * group, 2, s, d, dv, cuda, dtype)
    before = flash_mod.flash_attention_bwd.launches
    got = flash_mod.flash_attention_bwd(q, k, v, do, causal=causal)
    assert flash_mod.flash_attention_bwd.launches == before + 1
    tol = F32 if dtype == torch.float32 else BF16_BWD
    for name, g, w, t in zip("qkv", got, bwd_oracle(q, k, v, do, causal),
                             (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and g.is_contiguous()
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_at_224(cuda, s, group, causal):
    """bf16 alone takes (224, 224), Zamba2-7B's shared attention: the
    64-row tile edges and a ragged S, one and four query heads a KV head,
    against the float64 oracle at the bf16 tolerance."""
    rng = np.random.RandomState(448 + s + group)
    q, k, v, do = bwd_inputs(rng, 2, 2 * group, 2, s, 224, 224, cuda,
                             torch.bfloat16)
    got = flash_mod.flash_attention_bwd(q, k, v, do, causal=causal)
    for name, g, w in zip("qkv", got, bwd_oracle(q, k, v, do, causal)):
        torch.testing.assert_close(g.float(), w.float(), **BF16_BWD,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("s", [4096, 1000])
def test_flash_attention_224_at_zamba2s_shape(cuda, s):
    """Zamba2-7B's shared attention as the training microbatch runs it,
    (B, H, S, D) = (2, 32, 4096, 224) causal, and at a ragged S: the bf16
    forward against both plain versions and the backward against the
    float64 oracle (taken 4 heads at a time, whose gradients are their
    own), each one launch."""
    rng = np.random.RandomState(s)
    q, k, v, do = bwd_inputs(rng, 2, 32, 32, s, 224, 224, cuda,
                             torch.bfloat16)
    fwd = flash_mod.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert flash_mod.flash_attention.launches == fwd + 1
    for h in range(0, 32, 4):
        sl = (slice(None), slice(h, h + 4))
        want = flash_mod.plain(q[sl], k[sl], v[sl], causal=True)
        torch.testing.assert_close(got[sl].float(), want.float(), **BF16)
        want = flash_mod.plain(q[sl], k[sl], v[sl], causal=True,
                               bf16_scores=True)
        torch.testing.assert_close(got[sl].float(), want.float(),
                                   **TC_SCORES)
    bwd = flash_mod.flash_attention_bwd.launches
    grads = flash_mod.flash_attention_bwd(q, k, v, do, causal=True)
    assert flash_mod.flash_attention_bwd.launches == bwd + 1
    for h in range(0, 32, 4):
        sl = (slice(None), slice(h, h + 4))
        want = bwd_oracle(q[sl], k[sl], v[sl], do[sl], True)
        for name, g, w in zip("qkv", grads, want):
            torch.testing.assert_close(g[sl].float(), w.float(), **BF16_BWD,
                                       msg=lambda m: f"d{name}: {m}")


def test_flash_attention_f32_has_no_224(cuda):
    """The float32 kernels stop at D = 192: (224, 224) raises the head-dim
    error before any launch, forward and backward."""
    rng = np.random.RandomState(9)
    q, k, v, do = bwd_inputs(rng, 1, 2, 2, 64, 224, 224, cuda, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        flash_mod.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        flash_mod.flash_attention_bwd(q, k, v, do)


def test_flash_attention_bwd_kernel_is_deterministic(cuda):
    """No atomics: two calls give the same bits."""
    rng = np.random.RandomState(7)
    q, k, v, do = bwd_inputs(rng, 2, 8, 2, 300, 128, 128, cuda,
                             torch.float32)
    first = flash_mod.flash_attention_bwd(q, k, v, do)
    second = flash_mod.flash_attention_bwd(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_bwd_kernel_is_deterministic_in_bf16(cuda):
    """No atomics in bf16 either: two calls give the same bits, at a GQA
    group of 8 and many query tiles a key tile."""
    rng = np.random.RandomState(8)
    q, k, v, do = bwd_inputs(rng, 1, 16, 2, 700, 128, 128, cuda,
                             torch.bfloat16)
    first = flash_mod.flash_attention_bwd(q, k, v, do)
    second = flash_mod.flash_attention_bwd(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("how", ["odd stride", "unaligned base"])
def test_flash_attention_autograd_copies_a_do_tma_cannot_read(cuda, how):
    """A bf16 dO off TMA's 16-byte rules (a sequence stride of an odd
    number of elements, or a base 2 bytes past a 16-byte boundary) reaches
    the backward kernel through ops.flash_attention's autograd as a copy,
    and the gradients are those of the plain version's autograd."""
    rng = np.random.RandomState(13)
    q, k, v, do = bwd_inputs(rng, 2, 8, 2, 130, 64, 64, cuda, torch.bfloat16)
    if how == "odd stride":       # rows 65 elements apart
        wide = torch.zeros(2, 8, 130, 65, dtype=torch.bfloat16, device=cuda)
        wide[..., :64] = do
        do = wide[..., :64]
    else:                         # the flat buffer shifted by one element
        flat = torch.zeros(do.numel() + 1, dtype=torch.bfloat16, device=cuda)
        flat[1:] = do.reshape(-1)
        do = flat[1:].view(do.shape)
    assert not flash_mod.takes(do) and do.stride(-1) == 1
    with pytest.raises(ValueError, match="TMA"):
        flash_mod.flash_attention_bwd(q, k, v, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    bwd = flash_mod.flash_attention_bwd.launches
    got = torch.autograd.grad(ops.flash_attention(*leaves), leaves, do)
    assert flash_mod.flash_attention_bwd.launches == bwd + 1
    ref_leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_mod.plain(*ref_leaves), ref_leaves,
                               do.double())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **BF16_BWD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_takes_head_split_views(cuda, dtype):
    """(B, S, H, D) projections viewed as (B, H, S, D), and a dO of the
    same layout, read through their strides."""
    rng = np.random.RandomState(11)
    q, k, v, do = (rnd(rng, 2, 100, h, 64, device=cuda, dtype=dtype
                       ).transpose(1, 2) for h in (8, 2, 2, 8))
    got = flash_mod.flash_attention_bwd(q, k, v, do)
    want = bwd_oracle(q, k, v, do, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(
            g.float(), w.float(),
            **(F32 if dtype == torch.float32 else BF16_BWD))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bf16_scores", [False, True])
def test_flash_attention_autograd_on_the_card(cuda, dtype, bf16_scores):
    """ops.flash_attention under autograd: one forward and one backward
    launch, the gradients those of the plain version's autograd on the
    operands and dO the kernels were given (under ``bf16_scores`` q, k, v
    and a float32 dO rounded to bf16; float32-P, whatever the forward
    rounded)."""
    rng = np.random.RandomState(5)
    q, k, v, do = bwd_inputs(rng, 2, 8, 2, 130, 128, 128, cuda, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd = flash_mod.flash_attention.launches
    bwd = flash_mod.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, bf16_scores=bf16_scores)
    assert out.grad_fn is not None and out.dtype == dtype
    got = torch.autograd.grad(out, leaves, do)
    assert flash_mod.flash_attention.launches == fwd + 1
    assert flash_mod.flash_attention_bwd.launches == bwd + 1
    ops_ = [t.to(torch.bfloat16) if bf16_scores else t for t in (q, k, v)]
    ref_leaves = [t.double().requires_grad_() for t in ops_]
    want = torch.autograd.grad(
        flash_mod.plain(*ref_leaves), ref_leaves,
        do.to(ops_[0].dtype).double())
    for g, w in zip(got, want):
        torch.testing.assert_close(
            g.float(), w.float(),
            **(F32 if dtype == torch.float32 and not bf16_scores
               else BF16_BWD))


# Zamba2-2.7B's shared attention in a training microbatch, (2, 32, 4096,
# 80), cut to S = 512 (chip_smoke.py phase 2 runs the full shape)
ZAMBA2_TRAIN = (2, 32, 512, 80)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_at_zamba2s_training_shape(cuda, dtype):
    """Both flash kernels at (80, 80) through ``ops.flash_attention``'s
    autograd, on head-split views of (B, S, 2560) projections as the
    shared block hands them over: the forward against the plain version
    (bf16 also against its bf16-scores twin), the gradients against the
    plain backward in float64; one forward and one backward launch."""
    b, h, s, d = ZAMBA2_TRAIN
    rng = np.random.RandomState(81)
    q, k, v, do = (rnd(rng, b, s, h, d, device=cuda, dtype=dtype
                       ).transpose(1, 2) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd = flash_mod.flash_attention.launches
    bwd = flash_mod.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    assert flash_mod.flash_attention.launches == fwd + 1
    assert flash_mod.flash_attention_bwd.launches == bwd + 1
    want = flash_mod.plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, **F32)
    else:
        torch.testing.assert_close(out.float(), want.float(), **BF16)
        torch.testing.assert_close(
            out.float(), flash_mod.plain(q, k, v, bf16_scores=True).float(),
            **TC_SCORES)
    tol = F32 if dtype == torch.float32 else BF16_BWD
    for name, g, w in zip("qkv", got, bwd_oracle(q, k, v, do, True)):
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m: f"d{name}: {m}")


def test_remat_dots_trains_like_full_on_the_card(cuda):
    """The reduced Yi-6B's loss and gradients under ``remat="dots"`` equal
    those under "full" bit for bit on the card (the same kernels on the
    same operands), with the flash kernels launched as often: a forward
    and a recompute a layer, and a backward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.nn.model import LM
    from repro_torch.tree import leaves, unflatten

    cfg = get_config("yi_6b", reduced=True)
    params = LM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    runs = []
    for remat in ("full", "dots"):
        lm = LM(dataclasses.replace(cfg, remat=remat))
        flat = [t.detach().requires_grad_() for t in leaves(params)]
        fwd = flash_mod.flash_attention.launches
        bwd = flash_mod.flash_attention_bwd.launches
        loss, _ = lm.loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
        assert flash_mod.flash_attention.launches - fwd == 2 * cfg.n_layers
        assert flash_mod.flash_attention_bwd.launches - bwd == cfg.n_layers
        runs.append((loss, grads))
    (l_full, g_full), (l_dots, g_dots) = runs
    assert torch.equal(l_full, l_dots)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_dots))


def test_kernels_without_a_backward_raise_on_the_card(cuda):
    """fused_sigmoid_matmul (a card kernel with no backward: the paper's
    dense engine differentiates in its own IR) with an operand that
    requires grad raises before it launches; under no_grad it runs."""
    rng = np.random.RandomState(11)
    x, w = rnd(rng, 64, 32, device=cuda), rnd(rng, 32, 16, device=cuda)
    x.requires_grad_()
    before = fsm_mod.fused_sigmoid_matmul.launches
    with pytest.raises(NotImplementedError, match="own IR"):
        ops.fused_sigmoid_matmul(x, w)
    assert fsm_mod.fused_sigmoid_matmul.launches == before
    with torch.no_grad():
        ops.fused_sigmoid_matmul(x, w)
    assert fsm_mod.fused_sigmoid_matmul.launches == before + 1


# the MoE layer's training shape at DeepSeek-V2-Lite's widths (a microbatch
# of 2 x 4096 tokens in 4 groups: 64 experts x 4 groups x 240 slots), and
# a small one: T tokens, top-k, E experts, slots an expert, d_model
MOE_TRAIN = [(8192, 6, 64, 960, 2048), (256, 6, 64, 32, 256)]
# a bf16 gradient is a float32 sum rounded once to bf16: half a bf16 ulp,
# at most 2^-8 of the value, beyond F32
BF16_ONCE = dict(rtol=4.1e-3, atol=2e-5)


def moe_relations(rng, t, k, e, cap, device, drop=0.2):
    """The relations ``nn/moe.py::_moe_sort`` builds: the combine's
    token-major (row token, col its assignment's slot, value its gate; a
    dropped one slot 0 with value 0) and the dispatch's (slot → token,
    gate 1, or token 0 with gate 0 where the slot is empty)."""
    slots = e * cap
    nnz = t * k
    keep = rng.rand(nnz) >= drop
    cols = np.where(keep, rng.permutation(slots)[:nnz], 0)
    vals = np.where(keep, rng.rand(nnz), 0.0)
    rows = np.repeat(np.arange(t), k)
    live = np.zeros(slots, bool)
    live[cols[keep]] = True
    src = np.zeros(slots, np.int64)
    src[cols[keep]] = rows[keep]
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    return (as_i32(rows), as_i32(cols),
            torch.tensor(vals, dtype=torch.float32, device=device),
            as_i32(src), torch.tensor(live, dtype=torch.float32,
                                      device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,e,cap,d", MOE_TRAIN)
def test_tuple_dot_kernel(cuda, t, k, e, cap, d, dtype):
    """dOut (float32) against the expert rows (``dtype``), padding tuples
    0, held against the plain version in float64 at F32; two calls equal
    bit for bit.  dOut is drawn at d^-1/2 the scale of the rows, so each
    dot product is O(1), the scale F32's atol was set for: at unit scale a
    sum of 2048 products is about 45 in magnitude, and where it cancels
    near 0 float32 rounding alone (a float32 plain version's too) passes
    the atol (2.14e-05 at one of 49,152 tuples on an H100)."""
    rng = np.random.RandomState(t + d)
    rows, cols, _, _, _ = moe_relations(rng, t, k, e, cap, cuda)
    rows[-5:] = t                                   # padding
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    a = torch.randn(t, d, device=cuda, generator=gen) * d ** -0.5
    b = torch.randn(e * cap, d, device=cuda, generator=gen).to(dtype)
    before = dot_mod.tuple_dot.launches
    got = dot_mod.tuple_dot(a, rows, b, cols)
    assert dot_mod.tuple_dot.launches == before + 1
    want = dot_mod.plain(a.double(), rows, b.double(), cols).float()
    torch.testing.assert_close(got, want, **F32)
    assert (got[-5:] == 0).all()
    assert torch.equal(got, dot_mod.tuple_dot(a, rows, b, cols))


def test_tuple_dot_kernel_refusals(cuda):
    a = torch.ones(4, 12, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        dot_mod.tuple_dot(a, ids, a, ids)
    a = torch.ones(4, 16, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        dot_mod.tuple_dot(a, ids.long(), a, ids)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dot_mod.tuple_dot(a.double(), ids, a, ids)
    bad = torch.tensor([0, 7, 4], dtype=torch.int32, device=cuda)
    out = dot_mod.tuple_dot(a, ids, a, bad)          # col 7 and 4 of 4 rows
    assert out[0] == 16 and out[1:].isnan().all()


def moe_step(t, k, e, cap, d, dtype, device, seed):
    """The combine and the dispatch of one MoE layer as ``_moe_sort`` calls
    them, on random operands (made on the card: numpy's generator takes
    seconds for the 10^8 values of the training shape): the leaves (x, the
    combine's values, the expert rows), a function of them giving
    (dispatch output, combine output), the output gradients and the
    relations' ids."""
    rng = np.random.RandomState(seed)
    rows, cols, vals, src, live = moe_relations(rng, t, k, e, cap, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x, ys, dbuf = (torch.randn(n, d, device=device, generator=gen).to(dtype)
                   for n in (t, e * cap, e * cap))
    # at the gradient's scale, so that d vals (2048-term dot products) is
    # O(1), as in test_tuple_dot_kernel
    dout = torch.randn(t, d, device=device, generator=gen) * d ** -0.5

    def run(x, vals, ys):
        buf = ops.moe_dispatch(x, src, live)
        out = ops.relational_matmul(rows, cols, vals, ys, t)
        return buf, out

    return (x, vals, ys), run, (dbuf, dout), (rows, cols, src, live)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,e,cap,d", MOE_TRAIN)
def test_moe_functions_gradient_on_the_card(cuda, t, k, e, cap, d, dtype):
    """d x of the dispatch, d vals and d ys of the combine through the
    Functions (three relational_matmul launches and one tuple_dot), against
    autograd of the plain versions in float64 (F32; bf16 d x and d ys are
    a float32 sum rounded once, so at BF16_ONCE); two backward calls equal
    bit for bit."""
    leaves, run, (dbuf, dout), (rows, cols, src, live) = moe_step(
        t, k, e, cap, d, dtype, cuda, seed=t + cap)

    def grads():
        xs = [a.detach().clone().requires_grad_() for a in leaves]
        buf, out = run(*xs)
        return torch.autograd.grad((buf, out), xs, (dbuf, dout))

    counts = (relmm_mod.relational_matmul.launches,
              moe_mod.moe_dispatch.launches, dot_mod.tuple_dot.launches)
    got = grads()
    assert (relmm_mod.relational_matmul.launches - counts[0],
            moe_mod.moe_dispatch.launches - counts[1],
            dot_mod.tuple_dot.launches - counts[2]) == (3, 1, 1)
    xs = [a.detach().double().requires_grad_() for a in leaves]
    buf = moe_mod.plain(xs[0], src, live.double())
    out = relmm_mod.plain(rows, cols, xs[1], xs[2], t)
    want = torch.autograd.grad((buf, out), xs, (dbuf.double(), dout.double()))
    for name, g, w, leaf in zip(("x", "vals", "ys"), got, want, leaves):
        assert g.dtype == leaf.dtype and g.device == leaf.device, name
        tol = F32 if g.dtype == torch.float32 else BF16_ONCE
        torch.testing.assert_close(g.double(), w, **tol,
                                   msg=lambda m, n=name: f"d {n}: {m}")
    assert all(torch.equal(a, b) for a, b in zip(got, grads()))
