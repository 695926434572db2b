"""Zamba2 as published (``configs/zamba2_7b.py``, the ``hybrid_layer_ids``
layout of ``nn/model.py`` and the grouped Mamba-2 of ``nn/ssm.py``) on the
CPU, at a small size that keeps what makes the model: two B/C groups, two
shared blocks taken in turn by four uses (A, B, A, B), each use with its
own adapter and linear, attention at head dim 2d / heads, several chunks a
sequence.

* the port against the benchmark's plain reference
  (``portbench/reference/zamba2.py``, written apart from the port) in
  float32 on seeded random weights: logits, loss and every leaf's
  gradient, at float32's rounding through six layers (the two computed
  in bf16 part by 1e-2);
* that reference against ``transformers``' ``Zamba2ForCausalLM`` at a
  tiny ``Zamba2Config``, the weights copied across, eager attention (its
  torch path in one chunk: the test says why);
* the chunked SSD with two groups against the step-by-step recurrence, and
  one group bit for bit as the ungrouped arithmetic;
* which block and adapter each use reads, and the spans and the counter of
  a forward and of a remat backward.

The JAX package has no published Zamba2, so nothing here is held against
it; the JAX-parity tests of ``zamba2_2_7b`` (the JAX package's simplified
block) are in ``test_torch_ssm.py`` and ``test_torch_model.py``."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

import repro_torch.nn.layers as layers
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.nn import ssm
from repro_torch.nn.model import LM

from portbench import inputs, zamba2_inputs
from portbench.drivers.hybrid_train import arch_config
from portbench.reference import zamba2 as ref

ROOT = Path(__file__).resolve().parents[1]
#: the benchmark's configuration at a CPU size, every ratio of the source
#: kept but the heads' count (4 of 32 at head dim 2d / heads = 16)
SMALL = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=4,
             attention_head_dim=16, attention_hidden_size=64, kv_channels=8,
             mamba_headdim=8, n_mamba_heads=8, mamba_d_state=8, chunk_size=8,
             intermediate_size=48, ffn_hidden_size=48, adapter_rank=4,
             vocab_size=64, num_hidden_layers=6, hybrid_layer_ids=[1, 2, 4, 5])
SEQ = 32
TRAFFIC = {"remat": "full", "loss_impl": "full"}


def small_config() -> dict:
    c = json.loads((ROOT / "portbench/configs/zamba2-7b-24l.json")
                   .read_text())
    c.update(SMALL)
    c["layers_block_type"] = ["hybrid" if i in SMALL["hybrid_layer_ids"]
                              else "mamba" for i in range(6)]
    return c


def test_parameter_count_is_the_published_models():
    """Every parameter of the 81-layer model by hand: 7,356,749,648; the
    benchmark's 24 layers 2,733,050,240; and the count is what ``init``
    draws at the CPU size."""
    cfg = get_config("zamba2_7b")
    assert cfg.n_params == 7_356_749_648
    cut = dataclasses.replace(cfg, n_layers=24,
                              hybrid_layer_ids=(6, 11, 17, 23))
    assert cut.n_params == 2_733_050_240
    small = get_config("zamba2_7b", reduced=True)
    params = LM(small, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(v.numel() for _, v in ref.leaf_items(params)) \
        == small.n_params


def test_the_benchmarks_weights_have_the_ports_tree():
    c = small_config()
    port = LM(arch_config(c, TRAFFIC), device="cpu").init(
        torch.Generator().manual_seed(0))
    ours = zamba2_inputs.weights(c, inputs.generator(0, "cpu"))
    shapes = lambda t: {n: tuple(v.shape) for n, v in ref.leaf_items(t)}
    assert shapes(port) == shapes(ours)


def _grads(loss_of, params):
    names, flat = zip(*ref.leaf_items(params))
    tracked = [t.detach().requires_grad_() for t in flat]
    loss = loss_of(ref._rebuild(params, dict(zip(names, tracked))))
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                              tracked)))


@pytest.mark.parametrize("seed", [3, 11])
def test_port_matches_the_plain_reference_in_float32(monkeypatch, seed):
    """Logits, loss and every leaf's gradient of the port (remat "full")
    against the reference, both float32: within 1e-4 of the leaf's largest
    gradient (float32 through six layers reads 1.5e-5; bf16 products would
    read 1e-2)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    c = small_config()
    lm = LM(arch_config(c, TRAFFIC), device="cpu")
    model = ref.Model(c, "float32")
    params = zamba2_inputs.weights(c, inputs.generator(seed, "cpu"))
    batch = inputs.TokenStream(c["vocab_size"], SEQ, 2, seed,
                               "cpu").batch_at(0)
    with torch.no_grad():
        got = lm.forward(params, batch)[0]
        want = model.logits(params, batch["tokens"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    loss_p, g_p = _grads(lambda t: lm.loss_fn(t, batch)[0], params)
    loss_r, g_r = _grads(lambda t: model.loss(t, batch["tokens"],
                                              batch["labels"]), params)
    torch.testing.assert_close(loss_p, loss_r, rtol=1e-6, atol=1e-6)
    for name, want in g_r.items():
        scale = float(want.abs().max())
        assert scale > 0, name
        err = float((g_p[name] - want).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _to_transformers(c, params):
    """A ``Zamba2ForCausalLM`` of the small configuration holding
    ``params`` (the reference's tree), eager attention, float32."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Zamba2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_hidden_layers=c["num_hidden_layers"],
        layers_block_type=c["layers_block_type"],
        mamba_d_state=c["mamba_d_state"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"], mamba_ngroups=c["mamba_ngroups"],
        n_mamba_heads=c["n_mamba_heads"], use_conv_bias=True,
        chunk_size=SEQ, intermediate_size=c["intermediate_size"],
        hidden_act="gelu", num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        num_mem_blocks=c["num_mem_blocks"], adapter_rank=c["adapter_rank"],
        use_shared_attention_adapter=False, use_mem_rope=True,
        rope_theta=c["rope_theta"], rms_norm_eps=c["rms_norm_eps"],
        time_step_min=1e-12, time_step_limit=None,
        max_position_embeddings=SEQ, tie_word_embeddings=True)
    cfg._attn_implementation = "eager"
    model = transformers.Zamba2ForCausalLM(cfg).eval()
    t = lambda w: w.t().contiguous()
    ours = {}
    lay = ref._unbind(params["layers"])
    blocks = ref._unbind(params["shared_blocks"])
    uses = ref._unbind(params["hybrid"])
    use_of = {layer: j for j, layer in enumerate(c["hybrid_layer_ids"])}
    ours["model.embed_tokens.weight"] = params["embed"]
    ours["model.final_layernorm.weight"] = params["final_norm"]["w"]
    for i, lp in enumerate(lay):
        j = use_of.get(i)
        pre = (f"model.layers.{i}." if j is None
               else f"model.layers.{i}.mamba_decoder.")
        mx = lp["mixer"]
        ours[pre + "input_layernorm.weight"] = lp["norm1"]["w"]
        ours[pre + "mamba.in_proj.weight"] = t(mx["in_proj"])
        ours[pre + "mamba.conv1d.weight"] = t(mx["conv_w"])[:, None, :]
        ours[pre + "mamba.conv1d.bias"] = mx["conv_b"]
        ours[pre + "mamba.A_log"] = mx["a_log"]
        ours[pre + "mamba.dt_bias"] = mx["dt_bias"]
        ours[pre + "mamba.D"] = mx["d_skip"]
        ours[pre + "mamba.norm.weight"] = mx["norm"]["w"]
        ours[pre + "mamba.out_proj.weight"] = t(mx["out_proj"])
        if j is None:
            continue
        blk, use = blocks[j % c["num_mem_blocks"]], uses[j]
        st = f"model.layers.{i}.shared_transformer."
        ours[f"model.layers.{i}.linear.weight"] = t(use["linear"])
        for name in ("q", "k", "v", "o"):
            ours[st + f"self_attn.{name}_proj.weight"] = t(
                blk["attn"]["w" + name])
        ours[st + "input_layernorm.weight"] = blk["norm1"]["w"]
        ours[st + "pre_ff_layernorm.weight"] = blk["norm2"]["w"]
        ours[st + "feed_forward.gate_up_proj.weight"] = t(
            blk["mlp"]["gate_up"])
        ours[st + "feed_forward.down_proj.weight"] = t(blk["mlp"]["down"])
        ad = st + f"feed_forward.gate_up_proj_adapter_list.{j}."
        ours[ad + "0.weight"] = t(use["adapter"]["a"])
        ours[ad + "1.weight"] = t(use["adapter"]["b"])
    state = model.state_dict()
    with torch.no_grad():
        for name, value in ours.items():
            assert state[name].shape == value.shape, name
            state[name].copy_(value)
    # every weight of the model came from ours: the names a shared block
    # is known by in each layer that calls it, and the tied head, are views
    # of the tensors written
    written = {state[name].data_ptr() for name in ours}
    assert {v.data_ptr() for v in state.values()} == written
    assert torch.equal(state["lm_head.weight"], params["embed"])
    return model


@pytest.mark.parametrize("seed", [5, 17])
def test_reference_matches_transformers(seed):
    """The reference against ``transformers``' ``Zamba2ForCausalLM`` (its
    torch path: ``time_step_min`` 1e-12, so its clamp of dt never binds)
    on the same weights, float32: logits within float32 rounding.  The
    reference takes chunks of 8, ``transformers`` one chunk of the whole
    sequence: its torch path (4.57) sums the inter-chunk states over the
    target chunk's axis, not the source's (``.sum(dim=2)`` after
    ``decay_chunk[..., None, None] * states_permuted[:, :, None]``), which
    is exact for one chunk only; the exact decomposition gives the same
    output at any chunk, and the several-chunk path is held against the
    recurrence below."""
    c = small_config()
    params = zamba2_inputs.weights(c, inputs.generator(seed, "cpu"))
    hf = _to_transformers(c, params)
    tokens = inputs.TokenStream(c["vocab_size"], SEQ, 2, seed,
                                "cpu").batch_at(0)["tokens"]
    with torch.no_grad():
        want = hf(tokens.long()).logits
        got = ref.Model(c, "float32").logits(params, tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _ssd_inputs(seed, b=2, s=32, h=8, p=4, g=2, n=8, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen, dtype=dtype)
    dt = torch.rand(b, s, h, generator=gen, dtype=dtype) * 0.2 + 0.01
    a_head = -torch.arange(1, h + 1, dtype=dtype) / 4
    bg = torch.randn(b, s, g, n, generator=gen, dtype=dtype)
    cg = torch.randn(b, s, g, n, generator=gen, dtype=dtype)
    h0 = torch.randn(b, h, n, p, generator=gen, dtype=dtype) * 0.3
    return x, dt, a_head, bg, cg, h0


@pytest.mark.parametrize("with_state", [False, True])
def test_two_group_ssd_matches_the_recurrence(with_state):
    """``ssd_chunked`` with B and C in two groups (heads 0-3 read group 0,
    4-7 group 1) against ``ssd_naive``'s token-by-token recurrence, four
    chunks of 8, with and without an entering state: the outputs and the
    final state at float32's tolerance."""
    x, dt, a_head, bg, cg, h0 = _ssd_inputs(1)
    h0 = h0 if with_state else None
    a = dt * a_head
    y, h_fin = ssm.ssd_chunked(x * dt[..., None], a, bg, cg, chunk=8, h0=h0)
    y_n, h_n = ssm.ssd_naive(x * dt[..., None], a, bg, cg, h0=h0)
    torch.testing.assert_close(y, y_n, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(h_fin, h_n, rtol=2e-4, atol=2e-5)
    # a head reads its own group: group 1's B moved, heads 0-3 stay
    bg2 = bg.clone()
    bg2[:, :, 1] += 1.0
    y2, _ = ssm.ssd_chunked(x * dt[..., None], a, bg2, cg, chunk=8, h0=h0)
    assert torch.equal(y2[:, :, :4], y[:, :, :4])
    assert not torch.allclose(y2[:, :, 4:], y[:, :, 4:])


def test_reference_ssd_matches_the_recurrence(monkeypatch):
    """The reference's own chunked SSD (written apart from ``nn/ssm.py``)
    against the same recurrence, both in float64."""
    monkeypatch.setattr(layers, "ACCUM_DTYPE", torch.float64)
    x, dt, a_head, bg, cg, _ = _ssd_inputs(2, dtype=torch.float64)
    y = ref.ssd(x, dt, a_head, bg, cg, chunk=8)
    y_n, _ = ssm.ssd_naive(x * dt[..., None], dt * a_head, bg, cg,
                           h0=torch.zeros(2, 8, 8, 4, dtype=torch.float64))
    torch.testing.assert_close(y, y_n, rtol=1e-10, atol=1e-10)


def test_one_group_is_the_ungrouped_arithmetic_bit_for_bit():
    """B and C as (B, S, 1, N) run exactly the (B, S, N) arithmetic that
    the JAX twin's parity tests hold."""
    x, dt, a_head, bg, cg, h0 = _ssd_inputs(3, g=1)
    a = dt * a_head
    one = ssm.ssd_chunked(x, a, bg, cg, chunk=8, h0=h0)
    flat = ssm.ssd_chunked(x, a, bg[:, :, 0], cg[:, :, 0], chunk=8, h0=h0)
    assert all(torch.equal(p, q) for p, q in zip(one, flat))


def test_each_use_reads_its_adapter_and_block_j_mod_2(monkeypatch):
    """The forward hands use j the j-th adapter and linear and block j mod
    2; a use's output moves with its own adapter alone (each use run on
    the same inputs with one adapter changed)."""
    cfg = get_config("zamba2_7b", reduced=True)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(4))
    seen = {}
    run = LM._zamba2_shared

    def record(self, block, use, x, x0, cos, sin, j):
        seen[j] = (block, use, x.detach(), x0.detach(), cos, sin)
        return run(self, block, use, x, x0, cos, sin, j)

    monkeypatch.setattr(LM, "_zamba2_shared", record)
    tokens = torch.randint(0, cfg.vocab, (2, SEQ),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm.forward(params, {"tokens": tokens})
    assert sorted(seen) == [0, 1, 2, 3]
    hyb, blocks = params["hybrid"], params["shared_blocks"]
    for j, (block, use, *_) in seen.items():
        assert torch.equal(use["adapter"]["a"], hyb["adapter"]["a"][j])
        assert torch.equal(use["adapter"]["b"], hyb["adapter"]["b"][j])
        assert torch.equal(use["linear"], hyb["linear"][j])
        assert torch.equal(block["mlp"]["gate_up"],
                           blocks["mlp"]["gate_up"][j % 2])
    changed = {k: {"linear": v["linear"],
                   "adapter": {"a": v["adapter"]["a"],
                               "b": v["adapter"]["b"] + 0.5 * (k == 1)}}
               for k, (_, v, *_) in seen.items()}
    with torch.no_grad():
        for k, (block, use, x, x0, cos, sin) in seen.items():
            before = run(lm, block, use, x, x0, cos, sin, k)
            after = run(lm, block, changed[k], x, x0, cos, sin, k)
            assert torch.equal(before, after) == (k != 1), k


@pytest.mark.parametrize("remat", ["full", "none"])
def test_spans_and_the_uses_counter(remat):
    """A loss and its backward with a tracer installed: ``ssm.mixer`` (one
    a layer, with its index and tokens) and ``ssm.ssd`` (chunk, groups)
    once a layer, ``zamba2.shared`` (block, use) once a use, each again in
    the recompute of remat "full"; the counter ``zamba2.shared_uses``
    counts the forward's 4 uses only."""
    cfg = dataclasses.replace(get_config("zamba2_7b", reduced=True),
                              remat=remat)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(6))
    for t in (t for _, t in ref.leaf_items(params)):
        t.requires_grad_()
    toks = torch.randint(0, cfg.vocab, (2, SEQ + 1),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tracer = obs.Tracer()
    with obs.use(tracer):
        lm.loss_fn(params, batch)[0].backward()
    names = [s.name for s in tracer.spans]
    times = 2 if remat == "full" else 1
    assert names.count("ssm.mixer") == times * cfg.n_layers
    assert names.count("ssm.ssd") == times * cfg.n_layers
    assert names.count("zamba2.shared") == times * 4
    assert tracer.counters["zamba2.shared_uses"] == 4
    mixers = [s for s in tracer.spans if s.name == "ssm.mixer"]
    assert sorted({s.attrs["layer"] for s in mixers}) == list(range(6))
    assert all(s.attrs["tokens"] == 2 * SEQ for s in mixers)
    ssd = next(s for s in tracer.spans if s.name == "ssm.ssd")
    assert ssd.attrs == {"chunk": cfg.ssm.chunk, "groups": 2}
    uses = sorted((s.attrs["use"], s.attrs["block"]) for s in tracer.spans
                  if s.name == "zamba2.shared")
    assert sorted(set(uses)) == [(0, 0), (1, 1), (2, 0), (3, 1)]


def test_nothing_is_counted_while_nothing_traces():
    cfg = get_config("zamba2_7b", reduced=True)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(7))
    assert not obs.tracing()
    with torch.no_grad():
        lm.forward(params, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert "zamba2.shared_uses" not in obs.current().counters


def test_the_published_layout_builds_no_serving_cache():
    cfg = get_config("zamba2_7b", reduced=True)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(8))
    with pytest.raises(NotImplementedError, match="serving cache"):
        lm.prefill(params, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="serving cache"):
        lm.init_cache(1, 8)


def test_flash_takes_224_in_bf16_alone():
    """The bf16 kernels are built for Zamba2-7B's (224, 224), the float32
    ones are not (the wrapper raises its head-dim error for them)."""
    assert (224, 224) in flash_mod.head_dims(torch.bfloat16)
    assert (224, 224) not in flash_mod.head_dims(torch.float32)
    assert set(flash_mod.HEAD_DIMS) <= set(flash_mod.head_dims(
        torch.float32))
