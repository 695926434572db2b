"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec frontend is a STUB: input_specs() provides
precomputed frame embeddings (assignment spec). Post-embedding the backbone
is MHA + LayerNorm + GELU with sinusoidal positions."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_head=64, d_ff=6144, vocab=2048,
    norm="layernorm", mlp="gelu", rope=False,
    stub_frontend="audio_frames")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="musicgen-reduced", family="audio", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_head=32, d_ff=256, vocab=64,
        norm="layernorm", mlp="gelu", rope=False,
        stub_frontend="audio_frames")
