"""Qwen3-8B — dense GQA with per-head qk-norm [hf:Qwen/Qwen3-8B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=12288, vocab=151936, qk_norm=True,
    rope_theta=1e6)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b-reduced", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=256,
        qk_norm=True, rope_theta=1e6)
