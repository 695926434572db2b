"""The input makers, frozen here so that no later change to the program
changes what the benchmark feeds it.  Everything is made from ``--seed``:
tables and weights on the device with a ``torch.Generator``, in a few
large calls; token ids on the host with numpy's ``SeedSequence`` streams
(a few thousand a step).

* ``mnist_like``: ``repro_torch.data.make_mnist_like``'s arithmetic (ten
  prototypes in [0, 1)^784, uniform labels, x = proto[y] / 2 + U[0, 1) / 2)
  drawn from the device generator.
* ``listing2_weights``: Listing 2's initialisation, 2 U[0, 1) - 1.
* ``TokenStream``: ``repro_torch.data.TokenPipeline``'s stream (row r of
  step s from ``SeedSequence([seed, s, r])``, next-token labels).
* ``lm_weights``: the LM's parameter tree in the port's layout (the JAX
  package's: nested dicts, each layer stack with a leading L axis), every
  matrix N(0, 1) * fan_in ** -0.5 (the embedding * 0.02), the norms 1.
"""
from __future__ import annotations

import numpy as np
import torch

#: numbers a ``torch.randn`` call fills at most
_CHUNK = 1 << 30


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    return gen


def mnist_like(rows: int, features: int, classes: int,
               gen: torch.Generator):
    """(x (rows, features) float32, labels (rows,) int64) on gen's device."""
    dev = gen.device
    protos = torch.rand((classes, features), generator=gen, device=dev)
    labels = torch.randint(0, classes, (rows,), generator=gen, device=dev)
    noise = torch.rand((rows, features), generator=gen, device=dev)
    x = protos[labels].mul_(0.5).add_(noise.mul_(0.5))
    return x, labels


def listing2_weights(features: int, hidden: int, classes: int,
                     gen: torch.Generator) -> dict:
    dev = gen.device
    return {"w_xh": torch.rand((features, hidden), generator=gen,
                               device=dev).mul_(2).sub_(1),
            "w_ho": torch.rand((hidden, classes), generator=gen,
                               device=dev).mul_(2).sub_(1)}


class TokenStream:
    """Batches of ``global_batch`` rows of ``seq_len`` token ids and their
    next-token labels, int32 on ``device``; step s is the same for every
    run of one seed."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int, device):
        self.vocab, self.seq_len, self.rows = vocab, seq_len, global_batch
        self.seed = seed % 2 ** 64
        self.device = device

    def batch_at(self, step: int) -> dict:
        toks = np.stack([
            np.random.default_rng(np.random.SeedSequence(
                [self.seed, step, r])).integers(0, self.vocab,
                                                self.seq_len + 1,
                                                dtype=np.int32)
            for r in range(self.rows)])
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_layout(c: dict) -> dict:
    """The parameter tree of an MLA + MoE model (DeepSeek-V2's family) of
    config ``c`` (Hugging Face keys) as {name: subtree or (shape, scale)}:
    ``prologue`` holds the ``first_k_dense_replace`` dense-FFN layers,
    ``layers`` the MoE layers, each stacked on a leading axis."""
    d, vocab = c["hidden_size"], c["vocab_size"]
    h, kv = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    e, f, ns = (c["n_routed_experts"], c["moe_intermediate_size"],
                c["n_shared_experts"])
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense

    def mat(*shape, scale=None):
        return (shape, scale if scale is not None else shape[-2] ** -0.5)

    def norm(*shape):
        return (shape, None)

    def attn(n):
        return {"wq": mat(n, d, h * (dn + dr)), "wkv_a": mat(n, d, kv),
                "kv_a_norm": {"w": norm(n, kv)}, "wk_b": mat(n, kv, h * dn),
                "wv_b": mat(n, kv, h * dv), "wk_rope": mat(n, d, dr),
                "wo": mat(n, h * dv, d)}

    tree = {
        "embed": mat(vocab, d, scale=0.02),
        "layers": {
            "norm1": {"w": norm(n_moe, d)}, "norm2": {"w": norm(n_moe, d)},
            "attn": attn(n_moe),
            "moe": {"router": mat(n_moe, d, e), "wi": mat(n_moe, e, d, f),
                    "wg": mat(n_moe, e, d, f), "wo": mat(n_moe, e, f, d),
                    "shared": {"wi": mat(n_moe, d, ns * f),
                               "wg": mat(n_moe, d, ns * f),
                               "wo": mat(n_moe, ns * f, d)}}},
        "final_norm": {"w": norm(d)},
        "lm_head": mat(d, vocab),
    }
    if n_dense:
        fd = c["intermediate_size"]
        tree["prologue"] = {
            "norm1": {"w": norm(n_dense, d)}, "norm2": {"w": norm(n_dense, d)},
            "attn": attn(n_dense),
            "mlp": {"wi": mat(n_dense, d, fd), "wg": mat(n_dense, d, fd),
                    "wo": mat(n_dense, fd, d)}}
    return tree


def _walk(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def lm_weights(c: dict, gen: torch.Generator) -> dict:
    """``lm_layout(c)`` filled from ``gen``: every matrix a view of one
    float32 buffer that a few ``randn`` calls fill, in sorted-key order."""
    layout = lm_layout(c)
    mats = [(p, s, sc) for p, (s, sc) in _walk(layout) if sc is not None]
    total = sum(int(np.prod(s)) for _, s, _ in mats)
    flat = torch.empty(total, dtype=torch.float32, device=gen.device)
    for lo in range(0, total, _CHUNK):
        torch.randn(min(_CHUNK, total - lo), generator=gen,
                    out=flat[lo:lo + _CHUNK])
    out: dict = {}
    at = 0
    for path, (shape, scale) in _walk(layout):
        if scale is None:
            leaf = torch.ones(shape, dtype=torch.float32, device=gen.device)
        else:
            n = int(np.prod(shape))
            leaf = flat[at:at + n].view(shape).mul_(scale)
            at += n
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def n_params(c: dict) -> int:
    return sum(int(np.prod(s)) for _, (s, _) in _walk(lm_layout(c)))
