"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc``) every test here skips
with its reason.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  ``chip_smoke.py`` covers the same kernels at
the full main-path shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.relational import RelTensor
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import fused_sigmoid_matmul as fsm_mod
from repro_torch.kernels import onehot_embed as embed_mod
from repro_torch.kernels import ops
from repro_torch.kernels import relational_matmul as relmm_mod

pytestmark = pytest.mark.cuda

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=6e-2, atol=3e-2)


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
    rng = np.random.RandomState(m)
    rel = RelTensor.from_dense(rnd(rng, m, k, device=cuda))
    b = rnd(rng, k, n, device=cuda)
    before = relmm_mod.relational_matmul.launches
    got = ops.relational_matmul(rel.i, rel.j, rel.v, b, m)
    assert relmm_mod.relational_matmul.launches == before + 1
    torch.testing.assert_close(got, relmm_mod.plain(rel.i, rel.j, rel.v, b, m),
                               **F32)
    rel_t = rel.transpose()                     # the backward layout
    c = rnd(rng, m, n, device=cuda)
    torch.testing.assert_close(
        ops.relational_matmul(rel_t.i, rel_t.j, rel_t.v, c, k),
        relmm_mod.plain(rel_t.i, rel_t.j, rel_t.v, c, k), **F32)


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


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 256),
                                   (150, 4, 3), (2000, 200, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sigmoid_matmul_kernel(cuda, m, k, n, dtype):
    rng = np.random.RandomState(k)
    x, w = rnd(rng, m, k, device=cuda, dtype=dtype), rnd(rng, k, n,
                                                        device=cuda, dtype=dtype)
    got = ops.fused_sigmoid_matmul(x, w)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), fsm_mod.plain(x, w).float(),
                               **(F32 if dtype == torch.float32 else BF16))


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


def test_flash_attention_kernel_takes_head_split_views(cuda):
    """The model hands over (B, S, H, D) projections viewed as (B, H, S, D)."""
    rng = np.random.RandomState(0)
    q = rnd(rng, 2, 100, 4, 32, device=cuda).transpose(1, 2)
    k = rnd(rng, 2, 100, 2, 32, device=cuda).transpose(1, 2)
    v = rnd(rng, 2, 100, 2, 32, device=cuda).transpose(1, 2)
    torch.testing.assert_close(flash_mod.flash_attention(q, k, v),
                               flash_mod.plain(q, k, v), **F32)


def test_flash_attention_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention(q, q, q)
