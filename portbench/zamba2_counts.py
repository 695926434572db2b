"""The model FLOPs of a Zamba2 training token, frozen here as ``counts.py``
is, from the configuration file's keys (``mfu.hybrid_train`` reads them):

* 6 x the parameters a token's products touch: each Mamba-2 layer's
  in_proj, depthwise conv and out_proj; each hybrid use's q, k, v and o
  (from 2d), its gated MLP, its adapter and its linear; the output head
  (the tied embedding; the lookup is no product, the norms elementwise);
* causal attention at (D, Dv) = (head dim, head dim), forward and backward
  (3 x its forward: 2 (D + Dv) a query-key pair, (S + 1) / 2 keys a query);
* the SSD's own products, 3 x the forward's: within a chunk, C·Bᵀ (2 N a
  pair and group) and its product with x (2 P a pair and head) over the
  causal pairs of the chunk ((chunk + 1) / 2 keys a query); a token's
  share of the chunk state (2 N P a head) and of its read-out (2 N P).

Recompute is not counted."""
from __future__ import annotations


def active_params(c: dict) -> int:
    d, n = c["hidden_size"], c["num_hidden_layers"]
    di = c["mamba_expand"] * d
    conv = di + 2 * c["mamba_ngroups"] * c["mamba_d_state"]
    mamba = d * (di + conv + c["n_mamba_heads"]) + c["mamba_d_conv"] * conv \
        + di * d
    hd = c["num_attention_heads"] * c["attention_head_dim"]
    kv = c["num_key_value_heads"] * c["attention_head_dim"]
    ff, r = c["intermediate_size"], c["adapter_rank"]
    use = (2 * d * (hd + 2 * kv) + hd * d + 3 * d * ff
           + r * (d + 2 * ff) * c["use_shared_mlp_adapter"] + d * d)
    return n * mamba + len(c["hybrid_layer_ids"]) * use \
        + d * c["vocab_size"]


def attention_flops(c: dict, seq_len: int) -> float:
    """Forward and backward of the shared attention, a token, all uses."""
    dh = c["attention_head_dim"]
    fwd = c["num_attention_heads"] * 2 * (dh + dh) * (seq_len + 1) / 2.0
    return 3.0 * fwd * len(c["hybrid_layer_ids"])


def ssd_flops(c: dict) -> float:
    """Forward and backward of the SSD, a token, all layers."""
    q = c["chunk_size"]
    n, p = c["mamba_d_state"], c["mamba_headdim"]
    heads, groups = c["n_mamba_heads"], c["mamba_ngroups"]
    pairs = (q + 1) / 2.0
    fwd = (2 * n * groups * pairs + 2 * p * heads * pairs
           + 2 * 2 * n * p * heads)
    return 3.0 * fwd * c["num_hidden_layers"]


def train_flops_per_token(c: dict, seq_len: int) -> float:
    return (6.0 * active_params(c) + attention_flops(c, seq_len)
            + ssd_flops(c))
