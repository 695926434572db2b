"""Twins of ``repro.nn.model.LM`` for the port's dense, vlm and audio
families: JAX ``LM.init(PRNGKey(0))`` parameters pass through
``convert.from_jax_params`` into the port's ``LM``, and ``forward``,
``prefill`` (logits and cache) and 8 ``decode_step``s are compared on the
same numpy inputs, at each architecture's reduced config on the CPU.

Tolerances: with the compute type set to float32 in both packages (here
only, by monkeypatching ``COMPUTE_DTYPE``) ``rtol=2e-4, atol=2e-5``; in
the packages' own bf16 compute, ``tests/test_models_smoke.py``'s
``rtol=0.08, atol=0.05`` and the same greedy token.
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

ARCHS = ["yi_6b", "qwen3_8b", "qwen2_5_14b", "granite_3_8b",
         "musicgen_medium", "internvl2_1b"]
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=0.08, atol=0.05)
B, S, STEPS = 2, 12, 8


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """JAX ``LM.init(PRNGKey(0))``, float32 whatever the compute type, so
    the float32 and bf16 passes share it."""
    return jax.jit(JLM(jget_config(arch, reduced=True)).init)(
        jax.random.PRNGKey(0))


def build(arch):
    jlm = JLM(jget_config(arch, reduced=True))
    lm = LM(get_config(arch, reduced=True), device="cpu")
    jp = jax_params(arch)
    return jlm, jp, lm, convert.from_jax_params(jp, device="cpu")


def batch(cfg, seed=0, s=S):
    rng = np.random.RandomState(seed)
    if cfg.stub_frontend:
        e = rng.randn(B, s, cfg.d_model).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.randint(0, cfg.vocab, (B, s)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


def close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **tol)


def step_inputs(jb, tb, t):
    key = "embeds" if "embeds" in jb else "tokens"
    return {key: jb[key][:, t:t + 1]}, {key: tb[key][:, t:t + 1]}


def check_against_jax(arch, tol):
    jlm, jp, lm, tp = build(arch)
    jb, tb = batch(lm.cfg)
    jlog, _ = jax.jit(jlm.forward)(jp, jb)
    tlog, aux = lm.forward(tp, tb)
    assert tuple(tlog.shape) == (B, S, lm.cfg.vocab) and float(aux) == 0.0
    close(tlog, jlog, tol, f"{arch} forward")

    jlast, (jk, jv) = jax.jit(jlm.prefill)(jp, jb)
    tlast, (tk, tv) = lm.prefill(tp, tb)
    close(tlast, jlast, tol, f"{arch} prefill logits")
    close(tk, jk, tol, f"{arch} prefill K cache")
    close(tv, jv, tol, f"{arch} prefill V cache")

    jcache, tcache = jlm.init_cache(B, 16), lm.init_cache(B, 16)
    jdecode = jax.jit(jlm.decode_step)
    assert [tuple(c.shape) for c in tcache] == [c.shape for c in jcache]
    for t in range(STEPS):
        jsb, tsb = step_inputs(jb, tb, t)
        jl, jcache = jdecode(jp, jsb, jcache, jnp.int32(t))
        tl, tcache = lm.decode_step(tp, tsb, tcache, t)
        close(tl, jl, tol, f"{arch} decode step {t}")
    close(tcache[0], jcache[0], tol, f"{arch} decoded K cache")
    close(tcache[1], jcache[1], tol, f"{arch} decoded V cache")
    return jlast, tlast


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_jax_in_float32(f32_compute, arch):
    check_against_jax(arch, F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_jax_in_bf16(arch):
    jlast, tlast = check_against_jax(arch, BF16)
    np.testing.assert_array_equal(tlast.float().argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlast, -1)))


def test_prefill_matches_decode_path():
    """Greedy next token from prefill (full-sequence attention) == from
    token-by-token decode (attention over the cache), as the JAX model's
    test_models_smoke.py::test_prefill_matches_decode_path holds it."""
    lm = LM(get_config("yi_6b", reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, lm.cfg.vocab, (1, 8)).astype(np.int32))
    logits_p, _ = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(1, 16)
    for t in range(8):
        logits_d, cache = lm.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t)
    torch.testing.assert_close(logits_p[0, 0].float(), logits_d[0, 0].float(),
                               **BF16)
    assert int(logits_p.argmax()) == int(logits_d.argmax())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_jax_structure(arch):
    """LM.init draws a tree of the JAX init's structure, shapes and types,
    on the generator's device."""
    jlm = JLM(jget_config(arch, reduced=True))
    jp = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    lm = LM(get_config(arch, reduced=True), device="cpu")
    tp = lm.init(torch.Generator().manual_seed(0))

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", (tuple(v.shape), str(v.dtype))

    assert dict(flat(tp)) == {k: (s, d.replace("float32", "torch.float32"))
                              for k, (s, d) in flat(jp)}


def test_bf16_params_are_cast_like_jax():
    """param_dtype="bfloat16" casts every leaf of two or more axes (the
    stacked norms too), as the JAX init does."""
    change = dict(param_dtype="bfloat16")
    jlm = JLM(dataclasses.replace(jget_config("yi_6b", reduced=True),
                                  **change))
    jp = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    tp = LM(dataclasses.replace(get_config("yi_6b", reduced=True), **change),
            device="cpu").init(torch.Generator().manual_seed(0))
    for t, j in [(tp["layers"]["attn"]["wq"], jp["layers"]["attn"]["wq"]),
                 (tp["layers"]["norm1"]["w"], jp["layers"]["norm1"]["w"]),
                 (tp["final_norm"]["w"], jp["final_norm"]["w"])]:
        assert str(t.dtype) == f"torch.{j.dtype}"
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"]["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v2_lite_16b",
                                  "rwkv6_7b", "zamba2_2_7b"])
def test_families_outside_the_slice_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LM(get_config(arch, reduced=True), device="cpu")


@pytest.mark.parametrize("change", [dict(attn_impl="chunked"),
                                    dict(attn_impl="dense"),
                                    dict(flash_impl="scan"),
                                    dict(attn_bf16_scores=True)])
def test_attention_options_outside_the_slice_raise(change):
    cfg = dataclasses.replace(get_config("yi_6b", reduced=True), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LM(cfg, device="cpu")


def test_the_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(get_config("yi_6b", reduced=True))
