"""Zamba2-2.7B — Mamba-2 backbone + shared attention block every 6 layers
[arXiv:2411.15242]. Sub-quadratic backbone: runs long_500k (the shared
attention's KV cache is sequence-sharded at 500k). Per-application LoRA on
the shared block is omitted (DESIGN.md §8)."""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240, vocab=32000,
    ssm=SSMSpec(d_state=64, head_dim=64, d_conv=4, expand=2),
    shared_attn_every=6, sub_quadratic=True, rope_theta=1e4)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-reduced", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        ssm=SSMSpec(d_state=16, head_dim=16, d_conv=4, expand=2, chunk=16),
        shared_attn_every=2, sub_quadratic=True)
