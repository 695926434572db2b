"""Architecture assembly, PyTorch port of ``repro.nn.model.LM`` for the
families whose block is GQA attention plus an MLP:

  dense   — llama-style GQA + SwiGLU (yi, qwen3, qwen2.5, granite)
  vlm     — dense backbone, stub vision frontend feeds embeddings (internvl2)
  audio   — MHA + LayerNorm + GELU over stub EnCodec frame embeds (musicgen)

The parameter tree is the JAX package's: nested dicts, the layer stack
under ``params["layers"]`` with a leading L axis, float32 storage cast to
``layers.COMPUTE_DTYPE`` at use.  So ``convert.from_jax_params`` turns a
JAX ``LM.init`` tree into this class's parameters unchanged.  The JAX
``lax.scan`` over the stack is a Python loop over that axis.

Entry points:
  init(generator) → params
  forward(params, batch) → (logits (B,S,V), aux)
  prefill(params, batch) → (last-token logits, cache)   [flash kernel]
  decode_step(params, batch, cache, pos) → (logits, cache)

Full-sequence attention (``forward``, ``prefill``) goes through the
``flash_attention`` kernel on the card, one launch per layer; the decode
step attends over the cache in plain PyTorch.  ``decode_step`` writes the
step's K/V into ``cache`` in place (the JAX version returns a new cache),
so serving holds one cache, not two.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from . import layers as L

#: what this slice leaves out, and the ROADMAP.md item that brings it
_LATER = {
    "moe": "family 'moe' (routed experts, MLA) comes with the MoE slice "
           "(ROADMAP.md queue 1, item 13, and queue 2, kernel 4)",
    "ssm": "family 'ssm' (RWKV-6) comes with the RWKV-6 slice (ROADMAP.md "
           "queue 1, item 14, and queue 2, kernel 6)",
    "hybrid": "family 'hybrid' (Mamba-2 + shared attention) comes with "
              "ROADMAP.md queue 1, item 14",
    "attn_impl": "attn_impl={!r}: only 'flash' is ported; the chunked "
                 "schedule and the dense path come with ROADMAP.md queue 1, "
                 "item 12",
    "flash_impl": "flash_impl='scan' comes with ROADMAP.md queue 1, item 12 "
                  "(attend_flash_scan)",
    "attn_bf16_scores": "attn_bf16_scores=True comes with the flash "
                        "kernel's tensor-core rewrite (ROADMAP.md queue 2, "
                        "kernel 5 follow-on)",
}


def _index(tree, i: int):
    """One layer's parameters: leaf[i] of every leaf of a stacked tree."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _depth(tree) -> int:
    leaf = next(iter(tree.values()))
    return _depth(leaf) if isinstance(leaf, dict) else leaf.shape[0]


class LM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "vlm", "audio"):
            raise NotImplementedError(_LATER[cfg.family])
        if cfg.attn_impl != "flash":
            raise NotImplementedError(_LATER["attn_impl"].format(
                cfg.attn_impl))
        if cfg.flash_impl == "scan":
            raise NotImplementedError(_LATER["flash_impl"])
        if cfg.attn_bf16_scores:
            raise NotImplementedError(_LATER["attn_bf16_scores"])
        self.cfg = cfg
        self.device = resolve(device)

    # ------------------------------------------------------------------ init
    def _norm_init(self, d: int, lead=()):
        init = (L.rmsnorm_init if self.cfg.norm == "rmsnorm"
                else L.layernorm_init)
        return init(d, lead, self.device)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters from ``generator``, made on its device (which
        must be the model's), stored in float32 as the JAX package stores
        them.  Every stacked leaf is drawn at its full (L, ...) shape."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        d, v, n = cfg.d_model, cfg.vocab, cfg.n_layers
        layers: dict[str, Any] = {
            "norm1": self._norm_init(d, (n,)),
            "norm2": self._norm_init(d, (n,)),
            "attn": L.gqa_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head, qkv_bias=cfg.qkv_bias,
                               qk_norm=cfg.qk_norm, lead=(n,)),
            "mlp": (L.swiglu_init(generator, d, cfg.d_ff, lead=(n,))
                    if cfg.mlp == "swiglu"
                    else L.gelu_mlp_init(generator, d, cfg.d_ff, lead=(n,))),
        }
        params: dict[str, Any] = {
            "embed": L.dense_init(generator, (v, d), scale=0.02),
            "layers": layers,
            "final_norm": self._norm_init(d),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, (d, v))
        if cfg.param_dtype == "bfloat16":
            params = _map(lambda a: a.to(torch.bfloat16)
                          if a.dim() >= 2 and a.dtype == torch.float32
                          else a, params)
        return params

    # ------------------------------------------------------------- embedding
    def embed_inputs(self, params, batch) -> torch.Tensor:
        """tokens (B,S) → (B,S,d), or pass through stub-frontend embeds."""
        if "embeds" in batch:
            x = batch["embeds"].to(L.COMPUTE_DTYPE)
        else:
            x = params["embed"][batch["tokens"].long()].to(L.COMPUTE_DTYPE)
        if self.cfg.family == "audio" and not self.cfg.rope:
            b, s, d = x.shape
            pos = self._sinusoid(s, d, offset=0, device=x.device)
            x = x + pos[None].to(x.dtype)
        return x

    @staticmethod
    def _sinusoid(s, d, offset=0, device="cpu"):
        pos = torch.arange(offset, offset + s, dtype=torch.float32,
                           device=device)[:, None]
        i = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
        ang = pos / torch.pow(1e4, i / d)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def unembed(self, params, x) -> torch.Tensor:
        norm = (L.rmsnorm if self.cfg.norm == "rmsnorm" else L.layernorm)
        x = norm(params["final_norm"], x)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    # ------------------------------------------------------ layer-stack body
    def _attn_block(self, p, x, cos, sin, cache=None, pos=None):
        """Returns (out, kv): this call's K/V (full sequence) or the cache
        with this step's K/V written at ``pos`` (decode)."""
        cfg = self.cfg
        q, k, v = L.gqa_project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.d_head, cos, sin)
        if cache is None:
            o = L.attend_flash(q, k, v)
            return L.merge_heads(o) @ L.cdt(p["wo"]), (k, v)
        # decode: write this step's k/v at pos (clamped so it fits, as
        # lax.dynamic_update_slice clamps), attend over the valid prefix
        ck, cv = cache
        at = min(max(pos, 0), ck.shape[2] - k.shape[2])
        ck[:, :, at:at + k.shape[2]] = k.to(ck.dtype)
        cv[:, :, at:at + v.shape[2]] = v.to(cv.dtype)
        valid = (torch.arange(ck.shape[2], device=ck.device) <= pos)[None]
        o = L.attend(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                     kv_len_mask=valid.expand(x.shape[0], ck.shape[2]))
        return L.merge_heads(o) @ L.cdt(p["wo"]), (ck, cv)

    def _block(self, p, x, cos, sin, cache=None, pos=None):
        """One transformer block. Returns (x, aux_loss, new_cache)."""
        cfg = self.cfg
        norm = L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        attn_out, kv = self._attn_block(p["attn"], norm(p["norm1"], x),
                                        cos, sin, cache=cache, pos=pos)
        x = x + attn_out
        h = norm(p["norm2"], x)
        x = x + (L.swiglu(p["mlp"], h) if cfg.mlp == "swiglu"
                 else L.gelu_mlp(p["mlp"], h))
        return x, aux, kv

    def _scan(self, body, carry, stacked, *per_layer):
        """The JAX ``lax.scan`` over the layer stack as a Python loop:
        ``body(carry, layer_params, *per_layer_slices) → (carry, y)``;
        returns the carry and the list of ``y``."""
        ys = []
        for i in range(_depth(stacked)):
            carry, y = body(carry, _index(stacked, i),
                            *(a[i] for a in per_layer))
            ys.append(y)
        return carry, ys

    # ------------------------------------------------------------- forward
    def _rope(self, s: int, device):
        cfg = self.cfg
        return (L.rope_table(s, cfg.d_head, cfg.rope_theta, device=device)
                if cfg.rope else (None, None))

    def backbone(self, params, batch):
        """Full-sequence forward up to (but excluding) the LM head.
        Returns (hidden (B,S,d), aux_loss)."""
        x = self.embed_inputs(params, batch)
        cos, sin = self._rope(x.shape[1], x.device)

        def body(carry, lp):
            xx, aux = carry
            out, a, _ = self._block(lp, xx, cos, sin)
            return (out, aux + a), None

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        (x, aux), _ = self._scan(body, (x, aux), params["layers"])
        return x, aux

    def forward(self, params, batch):
        """Full-sequence forward → (logits (B,S,V), aux_loss)."""
        x, aux = self.backbone(params, batch)
        return self.unembed(params, x), aux

    # ------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int):
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len,
                 cfg.d_head)
        return (torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=self.device),
                torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=self.device))

    def decode_step(self, params, batch, cache, pos: int):
        """One token for every sequence. batch: {"tokens": (B,1)} or
        {"embeds": (B,1,d)}; pos: the current write position, shared by
        every sequence.  Writes into ``cache`` and returns it."""
        x = self.embed_inputs_decode(params, batch, pos)
        cos, sin = self._rope_at(pos, x.device) if self.cfg.rope \
            else (None, None)
        ck, cv = cache

        def body(carry, lp, k_l, v_l):
            out, _, _ = self._block(lp, carry, cos, sin, cache=(k_l, v_l),
                                    pos=pos)
            return out, None

        x, _ = self._scan(body, x, params["layers"], ck, cv)
        return self.unembed(params, x), (ck, cv)

    def embed_inputs_decode(self, params, batch, pos: int):
        if "embeds" in batch:
            x = batch["embeds"].to(L.COMPUTE_DTYPE)
        else:
            x = params["embed"][batch["tokens"].long()].to(L.COMPUTE_DTYPE)
        if self.cfg.family == "audio" and not self.cfg.rope:
            d = x.shape[-1]
            pos_f = torch.arange(0, d, 2, dtype=torch.float32,
                                 device=x.device)
            ang = float(pos) / torch.pow(1e4, pos_f / d)
            pe = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None]
            x = x + pe.to(x.dtype)
        return x

    def _rope_at(self, pos: int, device):
        dim = self.cfg.d_head
        inv = 1.0 / (self.cfg.rope_theta ** (
            torch.arange(0, dim, 2, dtype=torch.float32, device=device)
            / dim))
        ang = float(pos) * inv
        return torch.cos(ang)[None], torch.sin(ang)[None]

    def prefill(self, params, batch):
        """Full-context forward that also materialises the decode cache.
        Returns (last-position logits, cache (K, V), each (L,B,Hkv,S,dh))."""
        x = self.embed_inputs(params, batch)
        cos, sin = self._rope(x.shape[1], x.device)

        def body(carry, lp):
            out, _, kv = self._block(lp, carry, cos, sin)
            return out, kv

        x, kvs = self._scan(body, x, params["layers"])
        cache = (torch.stack([k for k, _ in kvs]),
                 torch.stack([v for _, v in kvs]))
        return self.unembed(params, x[:, -1:]), cache


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
