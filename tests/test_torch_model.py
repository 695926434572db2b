"""Twins of ``repro.nn.model.LM`` for the port's dense, moe, vlm, audio,
ssm and hybrid families: JAX ``LM.init(PRNGKey(0))`` parameters pass through
``convert.from_jax_params`` into the port's ``LM``, and ``forward``,
``prefill`` (logits and cache) and 8 ``decode_step``s are compared on the
same numpy inputs, at each architecture's reduced config on the CPU.  The
moe family (MLA DeepSeek-V2-Lite with its dense prologue layer, GQA DBRX)
runs in both MoE impls, ``einsum`` and ``sort``; the hybrid family
(Zamba2) also with ``ssm_bf16`` and ``ssd_impl="scan"``.

Tolerances: with the compute type set to float32 in both packages (here
only, by monkeypatching ``COMPUTE_DTYPE``) ``rtol=2e-4, atol=2e-5``; in
the packages' own bf16 compute, ``tests/test_models_smoke.py``'s
``rtol=0.08, atol=0.05`` and the same greedy token.

For the ssm family the bf16 check is a sanity bound only, atol 0.12; the
float32 twin is the binding one.  The two packages round at other places
in bf16: XLA on the CPU evaluates a bf16 sigmoid (``jax.nn.silu`` of the
gate, the channel mix's receptance) op by op, 1 / (1 + exp(-x)) with each
op rounded to bf16, where PyTorch rounds once.  Such flips compound
through the float32 recurrence and the per-head group norm, which divides
by each head's spread.  The gap is 0.078 on this test's input, 0.0625 to
0.1118 over input seeds 0 to 5 (Yi-6B's: 0.031 to 0.039), while JAX's own
bf16 logits differ from its float32 ones by 0.074 to 0.17 over the same
seeds (1.25 at seed 2): a bf16 gap here cannot tell the two compute types
apart.  The layers alone meet 0.08/0.05 (``tests/test_torch_ssm.py``).

The hybrid family (Zamba2) is read the same way, with a wider sanity
bound, atol 0.5.  One Mamba-2 mixer in bf16 is about 1 % (rms) from its
float32 self on the reduced model: the SSD's sums over the state cancel,
and the mixer's rmsnorm then scales tokens whose gated output is small
(rms 0.07 against 0.94 for others) back to unit size, so each layer
amplifies the rounding.  On this test's input the largest gap between the
two packages in bf16 is 0.34 (a prefill cache leaf; the logits 0.18), and
the bound is about 1.5 x that; over input seeds 0 to 5 the gap is
0.08 to 2.9, while JAX's own bf16 logits differ from its float32 ones by
0.22 to 1.62, and the greedy token agrees at every seed.  The float32
twin, at ``rtol=2e-4, atol=2e-5``, is the binding one; the mixer alone
meets 0.08/0.05 in bf16 (``tests/test_torch_ssm.py``).
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
         "musicgen_medium", "internvl2_1b", "rwkv6_7b", "zamba2_2_7b"]
MOE_ARCHS = ["deepseek_v2_lite_16b", "dbrx_132b"]
MOE_CASES = [(arch, impl) for arch in MOE_ARCHS for impl in ("einsum", "sort")]
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=0.08, atol=0.05)
BF16_SSM = dict(rtol=0.08, atol=0.12)
BF16_HYBRID = dict(rtol=0.08, atol=0.5)
BF16_ARCH = {"rwkv6_7b": BF16_SSM, "zamba2_2_7b": BF16_HYBRID}
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


def with_impl(cfg, impl):
    """The config with its MoE impl set (None: as it stands)."""
    if impl is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl=impl))


def build(arch, impl=None, options=None):
    """The JAX and port LMs of one reduced config (``options``: fields to
    replace in both), the JAX parameters and their conversion."""
    jcfg = with_impl(jget_config(arch, reduced=True), impl)
    cfg = with_impl(get_config(arch, reduced=True), impl)
    if options:
        jcfg = dataclasses.replace(jcfg, **options)
        cfg = dataclasses.replace(cfg, **options)
    jlm, lm = JLM(jcfg), LM(cfg, device="cpu")
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


def cache_leaves(cache):
    """The leaves of a cache tree (nested tuples), in order: K and V, the
    ssm family's x_prev, S and cm_prev, or the hybrid family's conv and SSM
    states and the shared block's K and V."""
    if isinstance(cache, tuple):
        return [leaf for c in cache for leaf in cache_leaves(c)]
    return [cache]


def step_inputs(jb, tb, t):
    key = "embeds" if "embeds" in jb else "tokens"
    return {key: jb[key][:, t:t + 1]}, {key: tb[key][:, t:t + 1]}


def check_against_jax(arch, tol, impl=None, options=None):
    jlm, jp, lm, tp = build(arch, impl, options)
    jb, tb = batch(lm.cfg)
    jlog, jaux = jax.jit(jlm.forward)(jp, jb)
    tlog, aux = lm.forward(tp, tb)
    assert tuple(tlog.shape) == (B, S, lm.cfg.vocab)
    close(tlog, jlog, tol, f"{arch} forward")
    if lm.cfg.moe is None:
        assert float(aux) == 0.0
    else:       # the load-balancing loss, summed over the MoE layers
        assert float(aux) > 0
        close(aux, jaux, tol, f"{arch} aux loss")

    jlast, jcache = jax.jit(jlm.prefill)(jp, jb)
    tlast, tcache = lm.prefill(tp, tb)
    close(tlast, jlast, tol, f"{arch} prefill logits")
    for i, (t, j) in enumerate(zip(cache_leaves(tcache),
                                   cache_leaves(jcache), strict=True)):
        close(t, j, tol, f"{arch} prefill cache leaf {i}")

    jcache, tcache = jlm.init_cache(B, 16), lm.init_cache(B, 16)
    jdecode = jax.jit(jlm.decode_step)
    assert [(tuple(c.shape), str(c.dtype)) for c in cache_leaves(tcache)] \
        == [(c.shape, f"torch.{c.dtype}") for c in cache_leaves(jcache)]
    for t in range(STEPS):
        jsb, tsb = step_inputs(jb, tb, t)
        jl, jcache = jdecode(jp, jsb, jcache, jnp.int32(t))
        tl, tcache = lm.decode_step(tp, tsb, tcache, t)
        close(tl, jl, tol, f"{arch} decode step {t}")
    for i, (t, j) in enumerate(zip(cache_leaves(tcache),
                                   cache_leaves(jcache), strict=True)):
        close(t, j, tol, f"{arch} decoded cache leaf {i}")
    return jlast, tlast


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_jax_in_float32(f32_compute, arch):
    check_against_jax(arch, F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_jax_in_bf16(arch):
    jlast, tlast = check_against_jax(arch, BF16_ARCH.get(arch, BF16))
    np.testing.assert_array_equal(tlast.float().argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlast, -1)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_scores_matches_jax(monkeypatch, compute):
    """``attn_bf16_scores=True`` on the reduced Yi-6B (S = 12, one chunk):
    prefill and forward round q, k, v and P to bf16 in both packages.  The
    JAX normaliser is also rounded to bf16 (tests/test_torch_layers.py), so
    even with float32 compute the twins hold at the bf16 tolerance, with
    the same greedy token."""
    if compute == "float32":
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    jlast, tlast = check_against_jax("yi_6b", BF16,
                                     options=dict(attn_bf16_scores=True))
    np.testing.assert_array_equal(tlast.float().argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlast, -1)))
    _, _, lm, tp = build("yi_6b")
    _, tb = batch(lm.cfg)
    plain_last, _ = lm.prefill(tp, tb)
    assert not torch.equal(tlast, plain_last)     # the option took effect


def test_bf16_scores_follows_the_jax_chunk_rule(f32_compute):
    """``attn_chunk`` 5 does not divide S = 12: JAX falls back to its
    float32 dense attention and the port to its float32 path, so the twins
    hold at the float32 tolerance."""
    check_against_jax("yi_6b", F32, options=dict(attn_bf16_scores=True,
                                                 attn_chunk=5))


@pytest.mark.parametrize("arch,impl", MOE_CASES)
def test_moe_matches_jax_in_float32(f32_compute, arch, impl):
    check_against_jax(arch, F32, impl)


@pytest.mark.parametrize("arch,impl", MOE_CASES)
def test_moe_matches_jax_in_bf16(arch, impl):
    jlast, tlast = check_against_jax(arch, BF16, impl)
    np.testing.assert_array_equal(tlast.float().argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jlast, -1)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_decode_path(f32_compute, arch):
    """The port's prefill (flash attention; MLA through the full heads)
    against 8 decode steps (attention over the cache; MLA's absorbed
    product in the latent space), sort impl, float32 compute.  Capacity is
    per group, and the two paths group differently (B·S tokens against B),
    so at the published capacity factor they may drop different
    assignments by the reference's own rule; at n_experts / top_k none can
    drop on either path."""
    cfg = with_impl(get_config(arch, reduced=True), "sort")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    logits_p, cache_p = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(B, 16)
    for t in range(8):
        logits_d, cache = lm.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t)
    torch.testing.assert_close(logits_p, logits_d, **F32)
    for p, d in zip(cache_leaves(cache_p), cache_leaves(cache), strict=True):
        torch.testing.assert_close(p, d[..., :8, :], **F32)   # sequence axis


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


def test_rwkv6_prefill_carries_the_decode_paths_state(f32_compute):
    """The ssm family's prefill (one kernel call per layer over the whole
    prompt) and 8 decode steps (one call per layer per token) end on the
    same logits and the same states, in float32 compute."""
    lm = LM(get_config("rwkv6_7b", reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, lm.cfg.vocab, (B, 8)).astype(np.int32))
    logits_p, cache_p = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(B, 16)
    for t in range(8):
        logits_d, cache = lm.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t)
    torch.testing.assert_close(logits_p, logits_d, **F32)
    for p, d in zip(cache_leaves(cache_p), cache_leaves(cache), strict=True):
        torch.testing.assert_close(p, d, **F32)


def test_zamba2_prefill_carries_the_decode_paths_state(f32_compute):
    """The hybrid family's prefill (SSD over the whole prompt, the shared
    block's attention through flash) and 8 decode steps (the Mamba-2
    recurrence a token, the shared attention over the cache) end on the
    same logits, Mamba states and shared K/V, in float32 compute."""
    lm = LM(get_config("zamba2_2_7b", reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, lm.cfg.vocab, (B, 8)).astype(np.int32))
    logits_p, cache_p = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(B, 16)
    for t in range(8):
        logits_d, cache = lm.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t)
    torch.testing.assert_close(logits_p, logits_d, **F32)
    (conv_p, h_p), (k_p, v_p) = cache_p
    (conv_d, h_d), (k_d, v_d) = cache
    torch.testing.assert_close(conv_p, conv_d, **F32)
    torch.testing.assert_close(h_p, h_d, **F32)
    for p, d in ((k_p, k_d), (v_p, v_d)):
        torch.testing.assert_close(p, d[..., :8, :], **F32)   # sequence axis
        assert not d[..., 8:, :].any()                         # unwritten


@pytest.mark.parametrize("options,tol", [(dict(ssm_bf16=True), BF16),
                                         (dict(ssd_impl="scan"), F32)])
def test_zamba2_options_follow_the_jax_model(f32_compute, options, tol):
    """``ssm_bf16`` (the SSD chunk math in bf16, float32 sums) and
    ``ssd_impl="scan"`` (one chunk at a time) on the reduced Zamba2 in
    float32 compute, S = 12 in one chunk: forward, prefill, decode and
    caches against the JAX model, ``scan`` at the float32 tolerance (the
    same function, float32 throughout) and ``ssm_bf16`` at the bf16 one
    (0.0058 at most here: the chunk tensors alone are rounded); and each
    option takes effect against the default config."""
    check_against_jax("zamba2_2_7b", tol, options=options)
    _, _, lm, tp = build("zamba2_2_7b")
    _, tb = batch(lm.cfg, s=16)
    cfg = dataclasses.replace(lm.cfg, ssm=dataclasses.replace(lm.cfg.ssm,
                                                              chunk=8),
                              **options)
    plain = dataclasses.replace(lm.cfg, ssm=cfg.ssm)
    got = LM(cfg, device="cpu").forward(tp, tb)[0]
    base = LM(plain, device="cpu").forward(tp, tb)[0]
    if "ssm_bf16" in options:
        assert not torch.equal(got, base)
    else:           # the same function, one chunk at a time
        torch.testing.assert_close(got, base, **F32)


def test_rwkv6_prefill_matches_decode_at_depth_in_float64(monkeypatch):
    """A narrow 32-layer RWKV-6 with every type raised to float64 (compute,
    norms, recurrence, states): the full-depth model amplifies rounding
    differences between the two paths by orders of magnitude, but in
    float64 there is next to none to amplify, so prefill and 8 decode
    steps end on the same logits and states at the full depth too."""
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float64)
    monkeypatch.setattr(TL, "ACCUM_DTYPE", torch.float64)
    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True),
                              n_layers=32)
    lm = LM(cfg, device="cpu")

    def f64(tree):
        return {k: f64(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}

    params = f64(lm.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    logits_p, cache_p = lm.prefill(params, {"tokens": toks})
    cache = lm.init_cache(B, 16)
    for t in range(8):
        logits_d, cache = lm.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t)
    assert logits_p.dtype == logits_d.dtype == torch.float64
    torch.testing.assert_close(logits_p, logits_d, rtol=1e-9, atol=1e-9)
    for p, d in zip(cache_leaves(cache_p), cache_leaves(cache), strict=True):
        assert p.dtype == d.dtype == torch.float64
        torch.testing.assert_close(p, d, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
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


@pytest.mark.parametrize("change", [dict(attn_impl="chunked"),
                                    dict(attn_impl="dense"),
                                    dict(flash_impl="scan")])
def test_attention_options_outside_the_slice_raise(f32_compute, change):
    """The attention options an earlier slice refused (the name is kept
    from then): ``forward``, ``prefill`` and the decode steps under each,
    against the JAX LM under the same option, in float32 (S = 12: one
    chunk, so "chunked" attends densely; ``tests/test_torch_attention_impls.py``
    holds it in chunks)."""
    check_against_jax("yi_6b", F32, options=change)


def test_the_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(get_config("yi_6b", reduced=True))
