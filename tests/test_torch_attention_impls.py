"""Twins of the JAX package's full-sequence attention options for the port:
``attend_chunked`` and ``attend_flash_scan`` against ``repro.nn.layers``'
on seeded numpy inputs (causal and not, a ``q_offset``, GQA, and v of
another head dim than q and k, as MLA has it), and ``LM`` under
``attn_impl`` "dense", "chunked" and "flash" and under
``flash_impl="scan"`` against the JAX ``LM`` under the same option.

Tolerances: the functions in float32 at rtol 1e-5, atol 1e-6 (the same
float32 sums in another order); the models at ``tests/test_torch_model.py``'s
float32 twin tolerance (rtol 2e-4, atol 2e-5), with the compute type
float32 in both packages (monkeypatched, here only); the four options of
the port against each other at that tolerance too, where
``tests/test_models_smoke.py`` holds JAX's own in bf16 at rtol 3e-2, atol
2e-2.
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
from repro_torch.nn.model import LM

FN = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=2e-4, atol=2e-5)
B, S = 2, 16
OPTIONS = {"dense": dict(attn_impl="dense"),
           "chunked": dict(attn_impl="chunked", attn_chunk=8),
           "flash": dict(attn_impl="flash", attn_chunk=8),
           "scan": dict(attn_impl="flash", flash_impl="scan", attn_chunk=8)}


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def qkv(b, hq, hkv, sq, skv, d, dv, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, w).astype(np.float32)
            for h, s, w in ((hq, sq, d), (hkv, skv, d), (hkv, skv, dv))]


def close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **tol)


# (B, Hq, Hkv, Sq, Skv, D, Dv, chunk, q_offset)
CHUNKED = [(2, 4, 4, 16, 16, 8, 8, 4, 0),       # MHA, 4 chunks
           (2, 8, 2, 16, 16, 16, 16, 8, 0),     # GQA
           (1, 4, 4, 24, 24, 12, 8, 8, 0),      # v narrower than q, k (MLA)
           (2, 4, 2, 8, 16, 8, 8, 4, 8),        # the last 8 of 16 positions
           (1, 4, 1, 6, 6, 8, 4, 8, 0)]         # S ≤ chunk: dense attend


@pytest.mark.parametrize("shape", CHUNKED, ids=[
    "mha", "gqa", "dv", "q_offset", "one_chunk"])
def test_attend_chunked_matches_jax(shape):
    b, hq, hkv, sq, skv, d, dv, chunk, q_offset = shape
    q, k, v = qkv(b, hq, hkv, sq, skv, d, dv)
    want = JL.attend_chunked(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                             q_offset=q_offset)
    got = TL.attend_chunked(*map(torch.from_numpy, (q, k, v)), chunk=chunk,
                            q_offset=q_offset)
    assert tuple(got.shape) == (b, hq, sq, dv)
    close(got, want, FN)


def test_attend_chunked_needs_a_dividing_chunk():
    """A sequence longer than the chunk and no multiple of it is refused,
    as the JAX version refuses it."""
    q, k, v = map(torch.from_numpy, qkv(1, 2, 2, 10, 10, 8, 8))
    with pytest.raises(AssertionError):
        TL.attend_chunked(q, k, v, chunk=4)
    with pytest.raises(AssertionError):
        JL.attend_chunked(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                             v.numpy())), chunk=4)


# (B, Hq, Hkv, S, D, Dv, chunk): S a multiple of the chunk (the scan), or
# not (JAX's dense fallback)
FLASH_SCAN = [(2, 4, 4, 16, 8, 8, 4), (2, 8, 2, 16, 16, 16, 8),
              (1, 4, 4, 24, 12, 8, 8), (1, 4, 1, 10, 8, 8, 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SCAN, ids=[
    "mha", "gqa", "dv", "ragged"])
def test_attend_flash_scan_matches_jax(shape, causal):
    b, hq, hkv, s, d, dv, chunk = shape
    q, k, v = qkv(b, hq, hkv, s, s, d, dv, seed=1)
    want = JL.attend_flash_scan(*map(jnp.asarray, (q, k, v)), chunk=chunk,
                                causal=causal)
    got = TL.attend_flash_scan(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    assert tuple(got.shape) == (b, hq, s, dv)
    close(got, want, FN)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(JLM(jget_config(arch, reduced=True)).init)(
        jax.random.PRNGKey(0))


def tokens(cfg, seed=0):
    t = np.random.RandomState(seed).randint(0, cfg.vocab, (B, S)).astype(
        np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def port_forward(arch, option):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **OPTIONS[option])
    lm = LM(cfg, device="cpu")
    params = convert.from_jax_params(jax_params(arch), device="cpu")
    return lm.forward(params, tokens(cfg)[1])[0]


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_lite_16b",
                                  "zamba2_2_7b"])
def test_lm_attention_option_matches_jax(f32_compute, arch, option):
    """The forward logits of the reduced Yi-6B (GQA), DeepSeek-V2-Lite (MLA:
    q/k and v of other head dims) and Zamba2-2.7B (the shared block) under
    each option, against the JAX LM under the same option; S = 16 in
    chunks of 8."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               **OPTIONS[option])
    want, _ = jax.jit(JLM(jcfg).forward)(jax_params(arch),
                                         tokens(jcfg)[0])
    close(port_forward(arch, option), want, F32, f"{arch} {option}")


def test_lm_attention_options_agree(f32_compute):
    """dense ≡ chunked ≡ flash ≡ flash scan in the port, as
    ``tests/test_models_smoke.py::test_attention_impls_agree`` holds
    JAX's."""
    outs = {o: port_forward("yi_6b", o) for o in OPTIONS}
    for option, out in outs.items():
        close(out, outs["flash"].numpy(), F32, option)
