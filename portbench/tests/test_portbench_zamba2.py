"""The Zamba2 cell's own pieces: its configuration against the published
one, its FLOP and parameter counts by hand, its readers on hand-built
sessions and observations, its reference against the port in float32,
and the fp8 control at a small size."""
import json
import types

import pytest
import torch

from portbench import (calibrate, compare, inputs, manifest, program_spans,
                       zamba2_counts, zamba2_inputs)
from portbench.reference import zamba2 as ref
from portbench.tests import small_zamba2
from portbench.tests.conftest import ROOT
from repro_torch.obs import SessionTracer

CELL = "zamba2-7b-24l.hybrid-train-4k"
#: the numbers of the published config.json (Zyphra/Zamba2-7B-Instruct)
PUBLISHED = {
    "adapter_rank": 128, "add_bias_linear": False, "attention_head_dim": 224,
    "attention_hidden_size": 7168, "chunk_size": 256,
    "ffn_hidden_size": 14336, "hidden_act": "gelu", "hidden_size": 3584,
    "intermediate_size": 14336, "kv_channels": 112, "mamba_d_conv": 4,
    "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64,
    "mamba_ngroups": 2, "max_position_embeddings": 4096,
    "model_type": "zamba2", "n_mamba_heads": 112, "num_attention_heads": 32,
    "num_hidden_layers": 81, "num_key_value_heads": 32,
    "num_logits_to_keep": 1, "num_mem_blocks": 2, "num_query_groups": 32,
    "rms_norm_eps": 1e-05, "rope_theta": 10000, "time_step_floor": 0.0001,
    "time_step_limit": None, "time_step_max": 0.1, "time_step_min": 0.001,
    "use_conv_bias": True, "use_long_context": False, "use_mem_rope": True,
    "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
    "vocab_size": 32000,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77]}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def config() -> dict:
    return manifest.cell(ROOT, CELL).config


def test_the_config_is_the_published_one_cut_to_24_layers():
    c = config()
    entry = next(e for e in BENCH["configs"] if e["name"] == c["name"])
    changed = {k for k, v in PUBLISHED.items() if c[k] != v}
    changed |= {"layers_block_type"}
    assert changed == set(entry["reduced"])
    assert c["num_hidden_layers"] == 24
    assert c["hybrid_layer_ids"] == [6, 11, 17, 23]
    assert [i for i, t in enumerate(c["layers_block_type"])
            if t == "hybrid"] == c["hybrid_layer_ids"]
    assert len(c["layers_block_type"]) == 24
    assert c["assumed"]["tie_word_embeddings"] is True
    assert entry["source"] in c["source"]


def test_parameter_count_by_hand():
    """24 Mamba-2 layers (in_proj 3584 x 14704, conv 4 x 7424 and its
    bias, A_log, dt_bias and D of 112, the gated norm's 7168, out_proj
    7168 x 3584, the layer norm's 3584), 4 uses' linear and adapter, two
    blocks, the tied embedding and the final norm."""
    mamba = (3584 * 14704 + 4 * 7424 + 7424 + 3 * 112 + 7168 + 7168 * 3584
             + 3584)
    block = 7168 + 3 * 7168 * 7168 + 7168 * 3584 + 3584 + 3 * 3584 * 14336
    use = 3584 * 3584 + 128 * (3584 + 2 * 14336)
    want = 24 * mamba + 4 * use + 2 * block + 32000 * 3584 + 3584
    assert want == 2_733_050_240
    assert zamba2_inputs.n_params(config()) == want


def test_flops_by_hand():
    """6 x the parameters a token's products touch (each use counts its
    block's), attention at (224, 224) over 4,096 causal keys, the SSD at
    chunk 256."""
    mamba = 3584 * 14704 + 4 * 7424 + 7168 * 3584
    use = (3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
           + 128 * (3584 + 2 * 14336) + 3584 * 3584)
    active = 24 * mamba + 4 * use + 3584 * 32000
    assert zamba2_counts.active_params(config()) == active
    attn = 3 * 4 * 32 * 2 * 448 * 4097 / 2
    assert zamba2_counts.attention_flops(config(), 4096) == attn
    ssd = 3 * 24 * (2 * 64 * 2 * 128.5 + 2 * 64 * 112 * 128.5
                    + 4 * 64 * 64 * 112)
    assert zamba2_counts.ssd_flops(config()) == pytest.approx(ssd)
    assert zamba2_counts.train_flops_per_token(config(), 4096) == \
        pytest.approx(6 * active + attn + ssd)


# -- the readers -------------------------------------------------------------

ENTRIES = {m["name"]: m for m in BENCH["per_layer"]
           if CELL in m.get("workloads", [])}
UNITS = 2


def reader(name):
    return manifest.metric_module(ENTRIES[name])


def test_every_new_metric_has_a_reader_and_lists_the_cell_alone():
    assert set(ENTRIES) == {
        "mfu.hybrid_train", "device_idle_share.hybrid_train",
        "optim_ms.hybrid_train", "flash_roofline.hybrid_train",
        "ssd_ms.hybrid_train", "shared_block_ms.hybrid_train",
        "ssd_host_ms.hybrid_train"}
    for name, entry in ENTRIES.items():
        assert entry["workloads"] == [CELL]
        assert entry["moves"] == "lm_train_tokens_per_s"
        reader(name)


def observed(calls=0, range_s=0.0, work=0.0):
    return types.SimpleNamespace(
        units=UNITS, window_s=4.0, busy_s=3.0, model_flops=989e12,
        calls={n: calls for n in ENTRIES}, range_s={n: range_s
                                                    for n in ENTRIES},
        work={n: work for n in ENTRIES},
        roofline=lambda n: (None if not calls or not range_s
                            else 100.0 * work / range_s))


@pytest.mark.parametrize("name,want", [
    ("mfu.hybrid_train", 25.0), ("device_idle_share.hybrid_train", 25.0),
    ("optim_ms.hybrid_train", 150.0), ("ssd_ms.hybrid_train", 150.0),
    ("shared_block_ms.hybrid_train", 150.0),
    ("flash_roofline.hybrid_train", 20.0)])
def test_reader_reads_the_observation(name, want):
    got = reader(name).read(observed(calls=3, range_s=0.3, work=0.06), name)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["optim_ms.hybrid_train",
                                  "ssd_ms.hybrid_train",
                                  "shared_block_ms.hybrid_train",
                                  "flash_roofline.hybrid_train"])
def test_a_reader_whose_calls_did_not_run_reads_none(name):
    assert reader(name).read(observed(), name) is None


def test_the_patched_calls_are_the_programs():
    """Each reader's targets name a function or method the program has (a
    module's attribute, or an object the driver hands over)."""
    import importlib
    for name in ENTRIES:
        for target in getattr(reader(name), "CALLS", {}):
            if target.startswith("@"):
                assert target in ("@optimizer.update",)
                continue
            module, qual = target.split(":")
            owner = importlib.import_module(module)
            for part in qual.split("."):
                owner = getattr(owner, part)
            assert callable(owner), target


def _session(monkeypatch, spans):
    session = SessionTracer()
    for s in spans:
        session._finish(types.SimpleNamespace(name=s[0], duration=s[1],
                                              attrs={}, _events=None))
    monkeypatch.setattr(program_spans, "session", lambda: session)


def test_ssd_host_ms_reads_the_spans(monkeypatch):
    _session(monkeypatch, [("train.step", 3.0)] * UNITS
             + [("ssm.ssd", 0.25), ("ssm.ssd", 0.05), ("ssm.mixer", 1.0)])
    got = reader("ssd_host_ms.hybrid_train").read(observed(), "")
    assert got == pytest.approx(1e3 * 0.3 / UNITS)


def test_ssd_host_ms_without_a_step_or_a_session_reads_none(monkeypatch):
    _session(monkeypatch, [("ssm.ssd", 0.25)])
    assert reader("ssd_host_ms.hybrid_train").read(observed(), "") is None
    monkeypatch.setattr(program_spans, "session", lambda: None)
    assert reader("ssd_host_ms.hybrid_train").read(observed(), "") is None


# -- the reference and the control -------------------------------------------

def small_cell():
    cell = manifest.cell(ROOT, CELL)
    small_zamba2.resize(cell)
    return cell


def test_reference_is_the_ports_function_in_float32(monkeypatch):
    """The loss and every gradient leaf of the port and the reference, both
    float32 on the CPU, agree to float32's rounding (1e-4 of a leaf's
    largest value)."""
    import repro_torch.nn.layers as layers
    from repro_torch.nn.model import LM
    from portbench.drivers.hybrid_train import arch_config
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    c = small_cell().config
    lm = LM(arch_config(c, {"remat": "full", "loss_impl": "full"}),
            device="cpu")
    params = zamba2_inputs.weights(c, inputs.generator(21, "cpu"))
    batch = inputs.TokenStream(c["vocab_size"], 64, 2, 21, "cpu").batch_at(0)
    names, flat = zip(*ref.leaf_items(params))

    def grads(loss_of):
        tracked = [t.detach().requires_grad_() for t in flat]
        loss = loss_of(ref._rebuild(params, dict(zip(names, tracked))))
        return loss.detach(), torch.autograd.grad(loss, tracked)

    loss_p, g_p = grads(lambda t: lm.loss_fn(t, batch)[0])
    model = ref.Model(c, "float32")
    loss_r, g_r = grads(lambda t: model.loss(t, batch["tokens"],
                                             batch["labels"]))
    assert float(abs(loss_p - loss_r)) <= 1e-6 * float(loss_r)
    for n, a, b in zip(names, g_p, g_r):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), n


@pytest.mark.parametrize("seed", [5, 6])
def test_the_fp8_control_fails_at_a_small_size(seed):
    """The reference in fp8 in the program's place parts from the bf16
    reference by three times what the program does, or more, on a number
    the cell compares, and by more than the cell's limit."""
    cell = small_cell()
    control = calibrate.control_numbers(cell, seed, "cpu")
    sound = calibrate.program_numbers(cell, seed, "cpu")
    assert any(control[n] >= 3 * sound[n] for n in cell.limits), (control,
                                                                  sound)
    assert not compare.passed(compare.verdict(control, cell.limits))
