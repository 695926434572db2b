"""Yi-6B — llama-architecture dense LM with GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000, rope_theta=5e6)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="yi-6b-reduced", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=256,
        rope_theta=5e6)
