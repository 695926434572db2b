"""DBRX-132B — 16-expert top-4 fine-grained MoE, GQA kv=8
[hf:databricks/dbrx-base; unverified]. Paper technique applies in full
(relational MoE dispatch)."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=10752, vocab=100352,
    moe=MoESpec(n_experts=16, top_k=4, d_ff_expert=10752,
                router_softmax="post"),
    rope_theta=5e5)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="dbrx-reduced", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=256,
        moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=128,
                    router_softmax="post"))
