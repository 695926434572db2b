"""The input maker of the Zamba2 cells, frozen here as ``inputs.py`` is:
the parameter tree of Zamba2 as published, in the port's layout for it
(``repro_torch.nn.model.LM`` with ``hybrid_layer_ids``), from ``--seed``.

* every matrix N(0, 1) * fan_in ** -0.5 (the embedding, tied to the output
  head, * 0.02), drawn as ``inputs.lm_weights`` draws them: one float32
  buffer that a few ``randn`` calls fill, in sorted-key order;
* the norms 1;
* the SSM parameters as the source initialises them (``transformers``'
  ``Zamba2PreTrainedModel._init_weights``): A_log = log(1 ... H), so A =
  -(1 ... H) in every layer; dt_bias the inverse softplus of dt drawn
  log-uniform in [time_step_min, time_step_max] (floored at
  time_step_floor), so that the decays are the trained model's range at
  its start; D = 1; the conv bias U(-1 / 2, 1 / 2), PyTorch's default
  for a depthwise conv of width 4, after the matrices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs


def _conv_width(c: dict) -> int:
    return (c["mamba_expand"] * c["hidden_size"]
            + 2 * c["mamba_ngroups"] * c["mamba_d_state"])


def layout(c: dict) -> dict:
    """{name: subtree or (shape, kind)}: kind a float (N(0, 1) times it),
    "ones", "a_log", "dt_bias" or "conv_b"."""
    d, vocab, n = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    di = c["mamba_expand"] * d
    heads = c["n_mamba_heads"]
    conv = _conv_width(c)
    m, u = c["num_mem_blocks"], len(c["hybrid_layer_ids"])
    ff, r = c["intermediate_size"], c["adapter_rank"]
    hd = c["num_attention_heads"] * c["attention_head_dim"]
    kv = c["num_key_value_heads"] * c["attention_head_dim"]

    def mat(*shape, scale=None):
        return (shape, scale if scale is not None else shape[-2] ** -0.5)

    def ones(*shape):
        return (shape, "ones")

    return {
        "embed": mat(vocab, d, scale=0.02),
        "layers": {
            "norm1": {"w": ones(n, d)},
            "mixer": {"in_proj": mat(n, d, di + conv + heads),
                      "conv_w": mat(n, c["mamba_d_conv"], conv, scale=0.5),
                      "conv_b": ((n, conv), "conv_b"),
                      "a_log": ((n, heads), "a_log"),
                      "dt_bias": ((n, heads), "dt_bias"),
                      "d_skip": ones(n, heads),
                      "norm": {"w": ones(n, di)},
                      "out_proj": mat(n, di, d)}},
        "shared_blocks": {
            "norm1": {"w": ones(m, 2 * d)},
            "attn": {"wq": mat(m, 2 * d, hd), "wk": mat(m, 2 * d, kv),
                     "wv": mat(m, 2 * d, kv), "wo": mat(m, hd, d)},
            "norm2": {"w": ones(m, d)},
            "mlp": {"gate_up": mat(m, d, 2 * ff), "down": mat(m, ff, d)}},
        "hybrid": {"linear": mat(u, d, d),
                   "adapter": {"a": mat(u, d, r), "b": mat(u, r, 2 * ff)}},
        "final_norm": {"w": ones(d)},
    }


def weights(c: dict, gen: torch.Generator) -> dict:
    """``layout(c)`` filled from ``gen``: the matrices first, as
    ``inputs.lm_weights`` fills them, then dt and the conv bias."""
    tree = layout(c)
    walk = list(inputs._walk(tree))
    mats = [(p, s) for p, (s, k) in walk if isinstance(k, float)]
    total = sum(int(np.prod(s)) for _, s in mats)
    dev = gen.device
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    for lo in range(0, total, inputs._CHUNK):
        torch.randn(min(inputs._CHUNK, total - lo), generator=gen,
                    out=flat[lo:lo + inputs._CHUNK])
    out: dict = {}
    at = 0
    lo_dt, hi_dt = math.log(c["time_step_min"]), math.log(c["time_step_max"])
    for path, (shape, kind) in walk:
        n = int(np.prod(shape))
        if isinstance(kind, float):
            leaf = flat[at:at + n].view(shape).mul_(kind)
            at += n
        elif kind == "ones":
            leaf = torch.ones(shape, dtype=torch.float32, device=dev)
        elif kind == "a_log":
            heads = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                 device=dev)
            leaf = torch.log(heads).expand(shape).contiguous()
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=dev)
            dt = torch.exp(u * (hi_dt - lo_dt) + lo_dt).clamp_(
                min=c["time_step_floor"])
            leaf = dt + torch.log(-torch.expm1(-dt))
        else:                                     # conv_b
            leaf = torch.rand(shape, generator=gen, device=dev).sub_(0.5)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def n_params(c: dict) -> int:
    return sum(int(np.prod(s)) for _, (s, _) in inputs._walk(layout(c)))
