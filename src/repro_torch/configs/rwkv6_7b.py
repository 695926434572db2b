"""RWKV-6 (Finch) 7B — attention-free, data-dependent vector decay
[arXiv:2404.05892]. Sub-quadratic: runs long_500k. The paper's
matmul-as-join technique is inapplicable to the recurrence
(DESIGN.md §Arch-applicability)."""
from .base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv_heads=64, d_head=64, d_ff=14336, vocab=65536, norm="layernorm",
    rope=False, ssm=SSMSpec(head_dim=64), sub_quadratic=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-reduced", family="ssm", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_head=32, d_ff=256, vocab=256,
        norm="layernorm", rope=False, ssm=SSMSpec(head_dim=32),
        sub_quadratic=True)
