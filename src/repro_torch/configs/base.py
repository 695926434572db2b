"""Architecture config schema + registry.

One ``<arch>.py`` per assigned architecture instantiates an ``ArchConfig``
with the exact published dimensions, and a ``reduced()`` variant for CPU
smoke tests. ``family`` selects the layer stack in ``nn.model``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0        # leading dense-FFN layers (DeepSeek)
    d_ff_dense: int = 0           # FFN width of those layers
    router_softmax: str = "pre"
    impl: str = "einsum"          # "einsum" (array rep) | "sort" (relational)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 64
    head_dim: int = 64            # P per head (mamba2) / N per head (rwkv6)
    d_conv: int = 4
    expand: int = 2
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | audio | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    mlp: str = "swiglu"           # swiglu | gelu
    rope: bool = True
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMSpec] = None
    stub_frontend: Optional[str] = None   # "audio_frames" | "vision_patches"
    shared_attn_every: int = 0            # zamba2: shared block period
    sub_quadratic: bool = False           # may run long_500k
    # execution knobs (hillclimbed in §Perf)
    attn_impl: str = "flash"              # flash | chunked | dense
    attn_chunk: int = 0                   # 0 = auto
    remat: str = "full"                   # none | full | dots
    scan_layers: bool = True
    ssm_bf16: bool = False                # SSD chunk math in bf16 (§Perf)
    attn_bf16_scores: bool = False        # flash score/prob blocks in bf16
    flash_impl: str = "unrolled"          # unrolled (exact FLOP count) |
                                          # scan (bounded-liveness memory)
    ssd_impl: str = "parallel"            # parallel | scan (same trade)
    param_dtype: str = "float32"          # float32 | bfloat16 (f32 master
                                          # weights live in the optimizer)
    loss_impl: str = "full"               # full | chunked (vocab-streamed CE)
    loss_chunk: int = 16384

    def n_heads_mamba(self) -> int:
        return (self.ssm.expand * self.d_model) // self.ssm.head_dim

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            blk = 5 * d * d + d * d + 2 * d * self.d_ff + d * d  # rwkv6-ish
        elif self.family == "hybrid":
            di = self.ssm.expand * d
            blk = d * (2 * di + 2 * self.ssm.d_state +
                       di // self.ssm.head_dim) + di * d
        else:
            if self.mla is not None:
                h = self.n_heads
                m = self.mla
                att = (d * h * (m.d_nope + m.d_rope) + d * m.kv_lora +
                       m.kv_lora * h * (m.d_nope + m.d_v) + d * m.d_rope +
                       h * m.d_v * d)
            else:
                att = (d * self.n_heads * self.d_head * 2 +
                       d * self.n_kv_heads * self.d_head * 2)
            if self.moe is not None:
                ff = (3 * d * self.moe.d_ff_expert *
                      (self.moe.n_experts + self.moe.n_shared))
            elif self.mlp == "swiglu":
                ff = 3 * d * self.d_ff
            else:
                ff = 2 * d * self.d_ff
            blk = att + ff
        total = emb + L * blk
        if self.shared_attn_every:
            total += (2 * self.d_model) * self.n_heads * self.d_head * 2 \
                + self.n_heads * self.d_head * self.d_model \
                + 3 * self.d_model * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.n_params
        d, L = self.d_model, self.n_layers
        full_ff = 3 * d * self.moe.d_ff_expert * (self.moe.n_experts +
                                                  self.moe.n_shared)
        act_ff = 3 * d * self.moe.d_ff_expert * (self.moe.top_k +
                                                 self.moe.n_shared)
        return self.n_params - L * (full_ff - act_ff)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "yi_6b", "qwen3_8b", "qwen2_5_14b", "granite_3_8b",
    "deepseek_v2_lite_16b", "dbrx_132b", "musicgen_medium", "rwkv6_7b",
    "internvl2_1b", "zamba2_2_7b",
]


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.reduced() if reduced else mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k only for sub-quadratic families (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False
    return True
