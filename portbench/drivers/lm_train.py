"""LM training through ``repro_torch.train.Trainer``: the step function
that ``Trainer`` builds (``make_train_step``: microbatches, the clip,
AdamW in place), fed as ``Trainer.run`` feeds it (a batch of the token
stream a step, the step's metrics read back, the card synchronised), on
weights and tokens made from the seed.

Set-up builds the trainer and its state and drives them through the first
three steps; the window goes on from there with the same objects.  The
reference follows the three steps from the same seed, and the loss of
each step, the first step's gradient as AdamW got it (its first moment
over 1 - b1, read after that step) and the change of the parameters after
the three are compared, the last two leaf by leaf."""
from __future__ import annotations

import gc
import time

import torch

from .. import compare, counts, harness, inputs
from ..reference import deepseek as ref

FIRST_STEPS = 3


def arch_config(c: dict, traffic: dict):
    """The port's ``ArchConfig`` of an MLA + MoE configuration file."""
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoESpec
    return ArchConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=c["qk_nope_head_dim"],
        d_ff=c["moe_intermediate_size"], vocab=c["vocab_size"],
        mla=MLAConfig(kv_lora=c["kv_lora_rank"], d_nope=c["qk_nope_head_dim"],
                      d_rope=c["qk_rope_head_dim"], d_v=c["v_head_dim"]),
        moe=MoESpec(n_experts=c["n_routed_experts"],
                    top_k=c["num_experts_per_tok"],
                    d_ff_expert=c["moe_intermediate_size"],
                    n_shared=c["n_shared_experts"],
                    first_k_dense=c["first_k_dense_replace"],
                    d_ff_dense=c["intermediate_size"],
                    router_softmax="pre", impl=c["moe_impl"],
                    capacity_factor=c["capacity_factor"]),
        rope_theta=c["rope_theta"], remat=traffic["remat"],
        loss_impl=traffic["loss_impl"])


def _leaf_norms(tree) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in ref.leaf_items(tree)}


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
    params = inputs.lm_weights(c, inputs.generator(ctx.seed, dev))
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
    start = dict(ref.leaf_items(inputs.lm_weights(
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
    flops = counts.lm_train_flops_per_token(c, tr["seq_len"]) * tokens
    return harness.Outcome(
        setup_s=setup_s, window_s=secs, units=units,
        end_to_end={tr["rate_metric"]: (units * tokens / secs, "tokens/s")},
        peak_bytes=peak, numbers=numbers,
        scale={"units": units, "model_flops": flops * units},
        reading=reading, probes=probes, check_s=time.perf_counter() - t0,
        readings={"program": program, "reference": reference})
