"""Zamba2-2.7B's sizes through the JAX package's simplified hybrid block
[arXiv:2411.15242], not the published 2.7B: one shared block (not two)
before every 6th layer, a 2d -> d ``in_proj`` before its attention (which
then runs at head dim 80, not 2d / heads), a SwiGLU with an inner residual,
the block's output added to the residual stream, no per-use LoRA adapters
(DESIGN.md §8), one SSM group, D applied to x·dt, no conv bias.  It is the
twin the JAX-parity tests hold the port to; ``zamba2_7b`` is the published
layout.  Sub-quadratic backbone: runs long_500k (the shared attention's KV
cache is sequence-sharded at 500k)."""
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
