"""InternVL2-1B — InternViT + 0.5B-class LM backbone [arXiv:2404.16821].
The vision tower is a STUB: input_specs() provides precomputed patch
embeddings mixed into the token stream; only the LM backbone (24L, d=896,
14H GQA kv=2) is modelled."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_head=64, d_ff=4864, vocab=151655, tie_embeddings=True,
    rope_theta=1e6, stub_frontend="vision_patches")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-reduced", family="vlm", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=256,
        tie_embeddings=True, stub_frontend="vision_patches")
