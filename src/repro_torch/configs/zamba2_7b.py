"""Zamba2-7B(-Instruct) as published [arXiv:2411.15242; the layer equations
of ``transformers``' ``models/zamba2/modeling_zamba2.py``; config
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json].

81 Mamba-2 layers at d = 3584: 112 heads of 64, d_state 64, two B/C
groups, chunk 256, a depthwise conv of width 4 with bias, dt unclamped, D
on x, a gated RMSNorm in two groups at eps 1e-5.  The 13 layers of
``hybrid_layer_ids`` first call one of two shared blocks in turn (use j
takes block j mod 2) on concat(hidden, embeddings), 7168 wide: RMSNorm,
32-head attention at head dim 224 with rope on all of it and softmax scale
(224 / 2) ** -0.5, RMSNorm, an exact-GELU gated MLP whose gate_up adds a
rank-128 LoRA of the use; the block has no residual of its own, and the
use's own 3584 x 3584 linear adds its output to the Mamba layer's input
before that layer's norm.  Tied embeddings (the source omits
``tie_word_embeddings``; ``transformers``' default ties them).
7,356,749,648 parameters."""
from .base import ArchConfig, SSMSpec

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_head=224, d_ff=14336, vocab=32000,
    mlp="geglu", tie_embeddings=True, rope_theta=1e4, norm_eps=1e-5,
    ssm=SSMSpec(d_state=64, head_dim=64, d_conv=4, expand=2, chunk=256,
                n_groups=2, conv_bias=True, d_on_x=True, norm_groups=2,
                norm_eps=1e-5),
    hybrid_layer_ids=HYBRID_LAYER_IDS, num_mem_blocks=2, adapter_rank=128,
    attn_scale=(224 / 2) ** -0.5)


def reduced() -> ArchConfig:
    """CPU-test size: 6 layers with 4 hybrid uses (blocks A, B, A, B), two
    groups, adapters, head dim 2 d / heads = 16, several chunks a
    sequence of 32."""
    return ArchConfig(
        name="zamba2-7b-reduced", family="hybrid", n_layers=6, d_model=32,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=48, vocab=64, mlp="geglu",
        tie_embeddings=True, rope_theta=1e4, norm_eps=1e-5,
        ssm=SSMSpec(d_state=8, head_dim=8, d_conv=4, expand=2, chunk=8,
                    n_groups=2, conv_bias=True, d_on_x=True, norm_groups=2,
                    norm_eps=1e-5),
        hybrid_layer_ids=(1, 2, 4, 5), num_mem_blocks=2, adapter_rank=4,
        attn_scale=(16 / 2) ** -0.5)
