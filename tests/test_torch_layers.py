"""Twins of the JAX package's ``nn.layers`` and of its flash-attention
kernel tests, for the port: the same numpy inputs through
``repro.nn.layers`` / ``repro.kernels`` and ``repro_torch.nn.layers`` /
``repro_torch.kernels`` on the CPU.

The port's full-sequence attention is ``ops.flash_attention``; on the CPU
it is the plain version, held here against the JAX ``ref``, the JAX
``attend_flash`` and the Pallas kernel in interpret mode.  Tolerances are
``tests/test_kernels.py``'s: float32 ``rtol=2e-4, atol=2e-5``, bf16
``rtol=6e-2, atol=3e-2``.  The layer functions run with the compute type
set to float32 in both packages (the point is the algorithm) and again in
bf16 where they cast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=6e-2, atol=3e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
FLASH_SWEEP = [(1, 4, 4, 128, 64, 64), (2, 8, 2, 256, 64, 128),
               (1, 8, 1, 256, 128, 128)]         # test_kernels.py:86-99


def pair(rng, shape, dtype="float32", scale=1.0):
    """The same values as a JAX array and a torch tensor of one type."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(rng.randn(*shape).astype(np.float32) * scale).astype(jdt)
    return j, torch.tensor(np.asarray(j, np.float32)).to(tdt)


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@pytest.fixture(params=["float32", "bfloat16"])
def compute(request, monkeypatch):
    """Both packages' compute type set to one type; yields its name."""
    jdt, tdt, _ = DTYPES[request.param]
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", tdt)
    return request.param


def params_of(jp: dict) -> dict:
    return convert.from_jax_params(jp, device="cpu")


# ---------------------------------------------------------------------------
# norms, rope, MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.RandomState(0)
    jx, tx = pair(rng, (2, 5, 32), dtype, scale=3.0)
    jw, tw = pair(rng, (32,))
    jb, tb = pair(rng, (32,))
    tol = DTYPES[dtype][2]
    got = TL.rmsnorm({"w": tw}, tx)
    assert got.dtype == tx.dtype
    close(got, JL.rmsnorm({"w": jw}, jx), tol)
    close(TL.layernorm({"w": tw, "b": tb}, tx),
          JL.layernorm({"w": jw, "b": jb}, jx), tol)
    assert set(TL.rmsnorm_init(8)) == set(JL.rmsnorm_init(8))
    ln = TL.layernorm_init(8, lead=(3,))
    assert ln["w"].shape == (3, 8) and float(ln["w"].sum()) == 24.0
    assert float(ln["b"].abs().sum()) == 0.0


@pytest.mark.parametrize("offset", [0, 5])
def test_rope(offset):
    cos, sin = TL.rope_table(7, 32, theta=5e6, offset=offset)
    jcos, jsin = JL.rope_table(7, 32, theta=5e6, offset=offset)
    close(cos, jcos, F32)
    close(sin, jsin, F32)
    rng = np.random.RandomState(1)
    jx, tx = pair(rng, (2, 4, 7, 32))
    close(TL.apply_rope(tx, cos, sin), JL.apply_rope(jx, jcos, jsin), F32)


def test_mlps(compute):
    rng = np.random.RandomState(2)
    tol = DTYPES[compute][2]
    jx, tx = pair(rng, (2, 5, 32), compute)
    key = jax.random.PRNGKey(0)
    sw = JL.swiglu_init(key, 32, 64)
    close(TL.swiglu(params_of(sw), tx), JL.swiglu(sw, jx), tol)
    gm = JL.gelu_mlp_init(key, 32, 64)
    gm = dict(gm, bi=jnp.asarray(rng.randn(64), jnp.float32),
              bo=jnp.asarray(rng.randn(32), jnp.float32))
    close(TL.gelu_mlp(params_of(gm), tx), JL.gelu_mlp(gm, jx), tol)


def test_inits_have_the_jax_structure():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for t, j in [(TL.swiglu_init(gen, 32, 64, lead=(3,)),
                  JL.swiglu_init(key, 32, 64)),
                 (TL.gelu_mlp_init(gen, 32, 64, lead=(3,)),
                  JL.gelu_mlp_init(key, 32, 64)),
                 (TL.gqa_init(gen, 32, 4, 2, 8, True, True, lead=(3,)),
                  JL.gqa_init(key, 32, 4, 2, 8, True, True))]:
        assert set(t) == set(j)
        for name, leaf in t.items():
            jleaf = j[name]["w"] if isinstance(leaf, dict) else j[name]
            tleaf = leaf["w"] if isinstance(leaf, dict) else leaf
            assert tuple(tleaf.shape) == (3,) + tuple(jleaf.shape), name
            assert tleaf.dtype == torch.float32
    w = TL.dense_init(gen, (4, 512, 256))       # fan-in 512 per layer
    assert abs(float(w.std()) - 512 ** -0.5) < 0.01 * 512 ** -0.5
    assert abs(float(TL.dense_init(gen, (1000, 64), 0.02).std()) - 0.02) \
        < 0.001


# ---------------------------------------------------------------------------
# GQA projections and the decode path's attend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_gqa_project_qkv(compute, qkv_bias, qk_norm):
    rng = np.random.RandomState(3)
    jp = JL.gqa_init(jax.random.PRNGKey(1), 32, 4, 2, 8, qkv_bias, qk_norm)
    if qkv_bias:
        jp = dict(jp, **{b: jnp.asarray(rng.randn(*jp[b].shape), jnp.float32)
                         for b in ("bq", "bk", "bv")})
    jx, tx = pair(rng, (2, 6, 32), compute)
    jcos, jsin = JL.rope_table(6, 8, 1e4)
    cos, sin = TL.rope_table(6, 8, 1e4)
    got = TL.gqa_project_qkv(params_of(jp), tx, 4, 2, 8, cos, sin)
    want = JL.gqa_project_qkv(jp, jx, 4, 2, 8, jcos, jsin)
    for t, j, shape in zip(got, want, [(2, 4, 6, 8), (2, 2, 6, 8),
                                       (2, 2, 6, 8)]):
        assert tuple(t.shape) == shape
        close(t, j, DTYPES[compute][2])


def test_split_and_merge_heads():
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    jx = jnp.asarray(x.numpy())
    heads = TL._split_heads(x, 4, 2)
    close(heads, JL._split_heads(jx, 4, 2), F32)
    assert torch.equal(TL.merge_heads(heads), x)


@pytest.mark.parametrize("sq,skv,q_offset,causal", [
    (6, 6, 0, True), (6, 6, 0, False), (4, 10, 6, True), (1, 10, 9, True)])
@pytest.mark.parametrize("ragged", [False, True])
def test_attend(sq, skv, q_offset, causal, ragged):
    rng = np.random.RandomState(sq * 10 + skv)
    jq, tq = pair(rng, (2, 4, sq, 16))
    jk, tk = pair(rng, (2, 2, skv, 16))
    jv, tv = pair(rng, (2, 2, skv, 16))
    mask = None
    if ragged:
        mask = np.arange(skv)[None, :] < np.array([[skv], [skv - 3]])
    got = TL.attend(tq, tk, tv, causal=causal, q_offset=q_offset,
                    kv_len_mask=None if mask is None
                    else torch.from_numpy(mask))
    want = JL.attend(jq, jk, jv, causal=causal, q_offset=q_offset,
                     kv_len_mask=None if mask is None else jnp.asarray(mask))
    close(got, want, F32)


# ---------------------------------------------------------------------------
# flash attention: the port's ops on the CPU (its plain version)
# ---------------------------------------------------------------------------

def flash_inputs(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.RandomState(seed)
    return (pair(rng, (b, hq, s, d), dtype), pair(rng, (b, hkv, s, d), dtype),
            pair(rng, (b, hkv, s, d), dtype))


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", FLASH_SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_ref(b, hq, hkv, s, d, blk, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(s + d, b, hq, hkv, s, d,
                                                dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    close(got, jref.flash_attention(jq, jk, jv, causal=causal),
          DTYPES[dtype][2])


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", FLASH_SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_interpret(b, hq, hkv, s, d, blk, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(s + d + 1, b, hq, hkv, s, d,
                                                dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True,
                                blk_q=blk, blk_k=blk)
    close(ops.flash_attention(tq, tk, tv, causal=causal), want,
          DTYPES[dtype][2])


def test_flash_matches_jax_attend_flash():
    """The port's kernel front ≡ the jnp online-softmax twin the JAX models
    use (test_kernels.py::test_flash_attention_matches_jnp_flash)."""
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(7, 2, 4, 2, 256, 64,
                                                "float32")
    want = JL.attend_flash(jq, jk, jv, chunk=128)
    close(ops.flash_attention(tq, tk, tv, causal=True), want, F32)
    close(TL.attend_flash(tq, tk, tv), want, F32)


@pytest.mark.parametrize("s", [100, 77])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ragged_seq(s, causal, dtype):
    """No divisibility rule: any S (the JAX ref has none either)."""
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(s, 2, 4, 2, s, 32, dtype)
    close(ops.flash_attention(tq, tk, tv, causal=causal),
          jref.flash_attention(jq, jk, jv, causal=causal), DTYPES[dtype][2])


def test_flash_on_the_cpu_is_the_plain_version_and_counts_no_launch():
    (_, tq), (_, tk), (_, tv) = flash_inputs(0, 1, 2, 1, 16, 32, "float32")
    before = flash_mod.flash_attention.launches
    assert torch.equal(ops.flash_attention(tq, tk, tv),
                       flash_mod.plain(tq, tk, tv))
    assert flash_mod.flash_attention.launches == before
    with pytest.raises(ValueError):       # the kernel itself takes no CPU
        flash_mod.flash_attention(tq, tk, tv)
