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
    # Mamba-2 as published (Zamba2-7B); the defaults are the JAX package's
    # mixer, which the zamba2_2_7b config runs
    n_groups: int = 1             # B and C groups: head h reads h // (H / G)
    conv_bias: bool = False       # a bias on the depthwise conv
    d_on_x: bool = False          # D·x (published), not D·(x·dt) (JAX's)
    norm_groups: int = 0          # gated RMSNorm of y·silu(z) in float32 in
                                  # this many groups; 0: JAX's rmsnorm of
                                  # the product in the compute type
    norm_eps: float = 1e-6        # that norm's epsilon


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
    mlp: str = "swiglu"           # swiglu | gelu | geglu (exact-GELU gated,
                                  # Zamba2-7B's shared block)
    rope: bool = True
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMSpec] = None
    stub_frontend: Optional[str] = None   # "audio_frames" | "vision_patches"
    shared_attn_every: int = 0            # zamba2 (JAX's block): period
    # Zamba2 as published: the layers in ``hybrid_layer_ids`` each call
    # shared block (use j: block j % num_mem_blocks) on concat(hidden,
    # embeddings) first, attention at head dim 2 d / n_heads with rope
    # (``rope``) on all of it, then ``mlp`` with a LoRA of ``adapter_rank``
    # on its gate_up that belongs to the use; a per-use d x d linear takes
    # the block's output to the Mamba layer's input, before its norm
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    attn_scale: float = 0.0               # softmax scale; 0: d_head ** -0.5
    norm_eps: float = 1e-6                # RMSNorm epsilon
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
        """Parameter count (embeddings + blocks): exact for the published
        Zamba2 layout, approximate for the others."""
        if self.hybrid_layer_ids:
            return self._zamba2_params()
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

    def _zamba2_params(self) -> int:
        """Every parameter of the published Zamba2 layout: the embedding
        (tied, or with an output head), each Mamba-2 layer, each hybrid
        layer's linear and adapter, the shared blocks, the final norm."""
        d, s = self.d_model, self.ssm
        di, h = s.expand * d, self.n_heads_mamba()
        conv = di + 2 * s.n_groups * s.d_state
        mamba = (d * (di + conv + h) + s.d_conv * conv
                 + conv * s.conv_bias + 3 * h + di + di * d + d)
        attn = 2 * d * self.n_heads * self.d_head * 3 \
            + self.n_heads * self.d_head * d
        block = 2 * d + attn + d + 3 * d * self.d_ff     # gated: gate_up, down
        uses = len(self.hybrid_layer_ids)
        adapter = self.adapter_rank * (d + 2 * self.d_ff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return (emb + self.n_layers * mamba + uses * (d * d + adapter)
                + self.num_mem_blocks * block + d)

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
