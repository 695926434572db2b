"""Granite-3.0-8B — dense GQA, tied embeddings [hf:ibm-granite/granite-3.0]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=12800, vocab=49155,
    tie_embeddings=True, rope_theta=1e4)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b-reduced", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=256,
        tie_embeddings=True)
