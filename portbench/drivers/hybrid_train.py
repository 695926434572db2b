"""Zamba2 training through ``repro_torch.train.Trainer``: the LM training
driver (``lm_train``) for the hybrid family as published.  The port's
``LM`` with ``hybrid_layer_ids`` is built from the configuration file, fed
as ``lm_train`` feeds DeepSeek (a batch of the token stream a step, the
step's metrics read back, the card synchronised), on weights of
``zamba2_inputs`` and tokens made from the seed.

Set-up builds the trainer and its state and drives them through the first
three steps; the window goes on from there.  The plain reference
(``reference/zamba2.py``) follows the three steps from the same seed, and
the loss of each step, the first step's gradient as AdamW got it and the
change of the parameters after the three are compared, as in
``lm_train``, and that gradient also element by element at a sample of
each leaf (``sampled``: ``grad_sample_gap``)."""
from __future__ import annotations

import gc
import time

import torch

from .. import compare, harness, inputs, sampled, zamba2_counts, zamba2_inputs
from ..reference import zamba2 as ref
from .lm_train import FIRST_STEPS, _leaf_norms


def arch_config(c: dict, traffic: dict):
    """The port's ``ArchConfig`` of a Zamba2 configuration file."""
    from repro_torch.configs.base import ArchConfig, SSMSpec
    ref.Model(c)                    # refuses what neither side implements
    dh = c["attention_head_dim"]
    groups = c["mamba_ngroups"]
    return ArchConfig(
        name=c["name"], family="hybrid", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=dh,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], mlp="geglu",
        tie_embeddings=ref.tied(c), rope=c["use_mem_rope"],
        rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"],
        ssm=SSMSpec(d_state=c["mamba_d_state"], head_dim=c["mamba_headdim"],
                    d_conv=c["mamba_d_conv"], expand=c["mamba_expand"],
                    chunk=c["chunk_size"], n_groups=groups,
                    conv_bias=c["use_conv_bias"], d_on_x=True,
                    norm_groups=groups, norm_eps=ref.GATED_EPS),
        hybrid_layer_ids=tuple(c["hybrid_layer_ids"]),
        num_mem_blocks=c["num_mem_blocks"],
        adapter_rank=c["adapter_rank"] * c["use_shared_mlp_adapter"],
        attn_scale=(dh / 2) ** -0.5, remat=traffic["remat"],
        loss_impl=traffic["loss_impl"])


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer

    ctx.mark("imports")
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    lm = LM(arch_config(c, tr), device=dev)
    stream = inputs.TokenStream(c["vocab_size"], tr["seq_len"],
                                tr["global_batch"], ctx.seed, dev)
    opt = adamw(tr["lr"], b1=tr["adam_b1"], b2=tr["adam_b2"],
                eps=tr["adam_eps"], weight_decay=tr["weight_decay"])
    trainer = Trainer(lm, opt, stream, grad_accum=tr["microbatches"],
                      clip_norm=tr["clip_norm"])
    params = zamba2_inputs.weights(c, inputs.generator(ctx.seed, dev))
    opt_state = opt.init(params)
    ctx.mark("weights and optimizer state")
    objects = {"trainer": trainer, "optimizer": opt, "model": lm,
               "microbatches": tr["microbatches"]}
    if ctx.on_built:
        ctx.on_built(objects)
    state = {"params": params, "opt": opt_state, "step": 0}
    losses = []

    def step(_=None):
        batch = stream.batch_at(state["step"])
        state["params"], state["opt"], metrics = trainer.step_fn(
            state["params"], state["opt"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        harness.synchronize(dev)
        state["step"] += 1
        return metrics

    for i in range(FIRST_STEPS):
        losses.append(step()["loss"])
        ctx.mark(f"step {i + 1}")
        if i == 0:
            grad1 = {n: v / (1.0 - tr["adam_b1"])
                     for n, v in _leaf_norms(state["opt"]["m"]).items()}
            sample1 = {n: v / (1.0 - tr["adam_b1"]) for n, v in
                       sampled.sample(ref.leaf_items(state["opt"]["m"]))
                       .items()}
    start = dict(ref.leaf_items(zamba2_inputs.weights(
        c, inputs.generator(ctx.seed, dev))))
    change = {n: float(torch.linalg.vector_norm(p - start[n]))
              for n, p in ref.leaf_items(state["params"])}
    del start
    program = {"loss": losses, "grads": [grad1], "change": change}

    units, secs, setup_s, reading, probes = harness.measured(ctx, step,
                                                             objects)
    peak = harness.peak_bytes(dev)
    tokens = tr["global_batch"] * tr["seq_len"]
    del state, params, opt_state, trainer, objects, lm
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = ref.train(c, tr, ctx.seed, dev, FIRST_STEPS)
    reference = {"loss": want["loss"], "grads": [want["grad1"]],
                 "change": want["change"]}
    numbers = compare.train_numbers(program, reference)
    numbers["grad_sample_gap"] = sampled.gap(sample1, want["sample1"])
    flops = zamba2_counts.train_flops_per_token(c, tr["seq_len"]) * tokens
    return harness.Outcome(
        setup_s=setup_s, window_s=secs, units=units,
        end_to_end={tr["rate_metric"]: (units * tokens / secs, "tokens/s")},
        peak_bytes=peak, numbers=numbers,
        scale={"units": units, "model_flops": flops * units},
        reading=reading, probes=probes, check_s=time.perf_counter() - t0,
        readings={"program": program, "reference": reference})
