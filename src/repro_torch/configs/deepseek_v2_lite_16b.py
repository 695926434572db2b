"""DeepSeek-V2-Lite (16B total) — MLA (kv_lora 512) + fine-grained MoE:
64 routed experts top-6 + 2 shared, leading dense FFN layer
[arXiv:2405.04434; hf]. The paper technique applies in full here: the
token→expert relation executes as join + group-by (nn/moe.py)."""
from .base import ArchConfig, MLAConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=1408, vocab=102400,
    mla=MLAConfig(kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                first_k_dense=1, d_ff_dense=10944, router_softmax="pre"),
    rope_theta=1e4)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-reduced", family="moe", n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=64, vocab=256,
        mla=MLAConfig(kv_lora=32, d_nope=16, d_rope=8, d_v=16),
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                    first_k_dense=1, d_ff_dense=128, router_softmax="pre"))
