"""Architecture assembly, PyTorch port of ``repro.nn.model.LM`` for these
families:

  dense   — llama-style GQA + SwiGLU (yi, qwen3, qwen2.5, granite)
  moe     — GQA or MLA attention + routed experts (dbrx, deepseek-v2-lite);
            leading dense-FFN layers live under ``params["prologue"]``
  vlm     — dense backbone, stub vision frontend feeds embeddings (internvl2)
  audio   — MHA + LayerNorm + GELU over stub EnCodec frame embeds (musicgen)
  ssm     — RWKV-6 time mix + channel mix, no attention (rwkv6)
  hybrid  — Mamba-2 (SSD) mixers with one shared attention + SwiGLU block
            applied before every ``shared_attn_every`` layers (zamba2); the
            shared block's weights live under ``params["shared_block"]``

The parameter tree is the JAX package's: nested dicts, the layer stack
under ``params["layers"]`` with a leading L axis, float32 storage cast to
``layers.COMPUTE_DTYPE`` at use.  So ``convert.from_jax_params`` turns a
JAX ``LM.init`` tree into this class's parameters unchanged.  The JAX
``lax.scan`` over the stack is a Python loop over that axis.

Entry points, and the kernels each runs on the card:
  init(generator) → params
  forward(params, batch) → (logits (B,S,V), aux)
  prefill(params, batch) → (last-token logits, cache)
      dense/vlm/audio: flash_attention a layer; ssm: rwkv6_scan a layer;
      moe: flash_attention a layer, with impl="sort" moe_dispatch and
      relational_matmul a MoE layer; hybrid: flash_attention a use of the
      shared block (n_layers / shared_attn_every)
  decode_step(params, batch, cache, pos) → (logits, cache)
      ssm: rwkv6_scan a layer; moe with impl="sort": moe_dispatch and
      relational_matmul a MoE layer; dense/vlm/audio and hybrid: none

Full-sequence attention (``forward``, ``prefill``) goes through the
``flash_attention`` kernel on the card, one launch per layer (MLA's too,
with q/k of head dim d_nope + d_rope and v of d_v; ``attn_bf16_scores``
rounds q, k, v and P to bf16 where the JAX chunk rule allows); the decode
step attends over the cache in plain PyTorch (MLA's in the compressed latent
space, the absorbed-matmul form, in float32).  The ssm family's time mix
goes through the ``rwkv6_scan`` kernel in every layer, in prefill and in
each decode step.  The moe family's routed experts go through
``nn/moe.py``: with ``impl="sort"``, ``moe_dispatch`` and
``relational_matmul`` once each per MoE layer, in prefill and in each
decode step.  The hybrid family's Mamba-2 mixers (``nn/ssm.py``'s SSD)
are PyTorch products with no kernel, as the JAX package's are jnp; its
shared block's full-sequence attention is the flash kernel at head dim
80.  ``decode_step`` writes the step's K/V (MLA: latent and rope key), or
the recurrent families' new states, into ``cache`` in place (the JAX
version returns a new cache), so serving holds one cache, not two.

Training: ``loss_fn(params, batch) → (loss, {"ce", "aux"})`` with
``cfg.loss_impl`` "full", "onehot" or "chunked" (vocab-streamed), the JAX
package's functions.  ``cfg.remat="full"`` recomputes each layer body of
``backbone`` in the backward pass (``torch.utils.checkpoint``, as JAX
wraps it in ``jax.checkpoint``), "none" keeps its activations.  On the
card the dense families train through both flash kernels: the forward
kernels, and ``flash_attention_bwd`` for the gradient.  The other kernels
have no backward yet and raise when an operand requires grad
(``kernels/ops.py``), so the moe family with ``impl="sort"`` and the ssm
family train on the CPU only, through the plain versions.  Every layer
loop unbinds the stacked leaves once (``_layers``) rather than indexing
them layer by layer: under autograd, ``leaf[i]`` would build a zero
gradient of the whole (L, ...) leaf for every layer.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from ..device import resolve
from ..tree import leaves
from . import layers as L
from . import moe as M
from . import ssm as S

#: what this slice leaves out, and the ROADMAP.md item that brings it
_LATER = {
    "attn_impl": "attn_impl={!r}: only 'flash' is ported; the chunked "
                 "schedule and the dense path come with ROADMAP.md queue 1, "
                 "item 12",
    "flash_impl": "flash_impl='scan' comes with ROADMAP.md queue 1, item 12 "
                  "(attend_flash_scan)",
    "remat": "remat='dots' (save the matrix products, recompute the rest) "
             "comes with ROADMAP.md queue 1, item 18, the dry-run that sets "
             "it",
}


def _moe_cfg(cfg: ArchConfig) -> M.MoEConfig:
    m = cfg.moe
    return M.MoEConfig(
        n_experts=m.n_experts, top_k=m.top_k, d_model=cfg.d_model,
        d_ff=m.d_ff_expert, n_shared=m.n_shared,
        capacity_factor=m.capacity_factor,
        router_softmax=m.router_softmax, impl=m.impl)


def _layers(tree) -> list[dict]:
    """Each layer's parameters of a stacked tree, every leaf unbound once
    along its L axis: the same views as ``leaf[i]``, and under autograd
    one backward that stacks the layers' gradients in one pass."""
    unbound = _map(lambda a: a.unbind(0), tree)
    return [_map(lambda parts: parts[i], unbound)
            for i in range(_depth(tree))]


def _depth(tree) -> int:
    leaf = next(iter(tree.values()))
    return _depth(leaf) if isinstance(leaf, dict) else leaf.shape[0]


class LM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.attn_impl != "flash":
            raise NotImplementedError(_LATER["attn_impl"].format(
                cfg.attn_impl))
        if cfg.flash_impl == "scan":
            raise NotImplementedError(_LATER["flash_impl"])
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
        d, v = cfg.d_model, cfg.vocab
        n_dense = cfg.moe.first_k_dense if cfg.moe else 0
        n = cfg.n_layers - n_dense
        layers: dict[str, Any] = {"norm1": self._norm_init(d, (n,))}
        if cfg.family != "hybrid":      # a hybrid layer has one norm
            layers["norm2"] = self._norm_init(d, (n,))
        if cfg.family == "hybrid":
            layers["mixer"] = S.mamba2_init(
                generator, d, cfg.n_heads_mamba(), cfg.ssm.d_state,
                cfg.ssm.d_conv, cfg.ssm.expand, lead=(n,))
        elif cfg.family == "ssm":
            layers["tmix"] = S.rwkv6_init(generator, d, self._ssm_heads,
                                          lead=(n,))
            layers["cmix"] = S.rwkv6_channel_mix_init(generator, d, cfg.d_ff,
                                                      lead=(n,))
        else:
            layers["attn"] = self._attn_init(generator, (n,))
            if cfg.family == "moe":
                layers["moe"] = M.init_moe(generator, _moe_cfg(cfg),
                                           lead=(n,))
            elif cfg.mlp == "swiglu":
                layers["mlp"] = L.swiglu_init(generator, d, cfg.d_ff,
                                              lead=(n,))
            else:
                layers["mlp"] = L.gelu_mlp_init(generator, d, cfg.d_ff,
                                                lead=(n,))
        params: dict[str, Any] = {
            "embed": L.dense_init(generator, (v, d), scale=0.02),
            "layers": layers,
            "final_norm": self._norm_init(d),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, (d, v))
        if n_dense:
            # the leading dense-FFN layers (DeepSeek); their GQA attention,
            # if any, without bias or qk-norm, as the JAX init has it
            params["prologue"] = {
                "norm1": self._norm_init(d, (n_dense,)),
                "norm2": self._norm_init(d, (n_dense,)),
                "attn": self._attn_init(generator, (n_dense,), plain=True),
                "mlp": L.swiglu_init(generator, d, cfg.moe.d_ff_dense,
                                     lead=(n_dense,)),
            }
        if cfg.shared_attn_every:
            # Zamba2's shared block: (hidden, embeddings) → d, then a plain
            # GQA attention and a SwiGLU, as the JAX init has it
            params["shared_block"] = {
                "in_proj": L.dense_init(generator, (2 * d, d)),
                "norm1": L.rmsnorm_init(d, device=self.device),
                "norm2": L.rmsnorm_init(d, device=self.device),
                "attn": L.gqa_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.d_head),
                "mlp": L.swiglu_init(generator, d, cfg.d_ff),
            }
        if cfg.param_dtype == "bfloat16":
            params = _map(lambda a: a.to(torch.bfloat16)
                          if a.dim() >= 2 and a.dtype == torch.float32
                          else a, params)
        return params

    def _attn_init(self, generator, lead, plain: bool = False):
        cfg = self.cfg
        if cfg.mla is not None:
            m = cfg.mla
            return L.mla_init(generator, cfg.d_model, cfg.n_heads, m.kv_lora,
                              m.d_nope, m.d_rope, m.d_v, lead=lead)
        return L.gqa_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, qkv_bias=cfg.qkv_bias and not plain,
                          qk_norm=cfg.qk_norm and not plain, lead=lead)

    @property
    def _ssm_heads(self) -> int:
        return self.cfg.d_model // self.cfg.ssm.head_dim

    @property
    def _mamba_dims(self) -> tuple[int, int, int, int]:
        """(d_inner, head_dim, d_state, d_conv) of the Mamba-2 mixers."""
        ssm = self.cfg.ssm
        return (ssm.expand * self.cfg.d_model, ssm.head_dim, ssm.d_state,
                ssm.d_conv)

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
    def _attend_full(self, q, k, v):
        """Full-sequence attention as the JAX ``LM._attend_full`` runs it
        for ``attn_impl="flash"``: the chunk (``attn_chunk`` or auto)
        decides where ``attn_bf16_scores`` holds."""
        return L.attend_flash(q, k, v, bf16_scores=self.cfg.attn_bf16_scores,
                              chunk=self.cfg.attn_chunk or None)

    def _attn_block(self, p, x, cos, sin, cache=None, pos=None):
        """Returns (out, kv): this call's K/V (full sequence; MLA: the
        latent c_kv and the rope key) or the cache with this step's
        entries written at ``pos`` (decode)."""
        cfg = self.cfg
        if cfg.mla is not None:
            if cache is not None:
                return self._mla_attn_decode(p, x, cos, sin, cache, pos)
            m = cfg.mla
            q, k, v, c_kv = L.mla_qkv(p, x, cfg.n_heads, m.d_nope, m.d_rope,
                                      m.d_v, cos, sin)
            o = self._attend_full(q, k, v)
            # every head's rope key is the shared one
            k_rope = k[:, 0, :, m.d_nope:].contiguous()
            return L.merge_heads(o) @ L.cdt(p["wo"]), (c_kv, k_rope)
        q, k, v = L.gqa_project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.d_head, cos, sin)
        if cache is None:
            o = self._attend_full(q, k, v)
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

    def _mla_attn_decode(self, p, x, cos, sin, cache, pos):
        """Absorbed-matmul MLA decode: attend in the compressed latent
        space, in float32.  The cache holds (c_kv (B,S,kv_lora), k_rope
        (B,S,d_rope)) only, the MLA memory saving; this step's entries are
        written at ``pos`` in place."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        f32 = torch.float32
        q = (x @ L.cdt(p["wq"])).reshape(b, s, cfg.n_heads,
                                         m.d_nope + m.d_rope).transpose(1, 2)
        q_nope = q[..., :m.d_nope]
        q_rope = L.apply_rope(q[..., m.d_nope:], cos, sin)
        c_kv_t = L.rmsnorm(p["kv_a_norm"], x @ L.cdt(p["wkv_a"]))
        k_rope_t = L.apply_rope((x @ L.cdt(p["wk_rope"]))[:, None], cos,
                                sin)[:, 0]
        ckv, krope = cache
        at = min(max(pos, 0), ckv.shape[1] - s)
        ckv[:, at:at + s] = c_kv_t.to(ckv.dtype)
        krope[:, at:at + s] = k_rope_t.to(krope.dtype)
        # q_abs (B,H,kv_lora) = q_nope · wk_bᵀ, so the product with the
        # cache runs in the latent space
        wk_b = p["wk_b"].reshape(m.kv_lora, cfg.n_heads, m.d_nope)
        q_abs = torch.einsum("bhd,chd->bhc", q_nope[:, :, 0].to(f32),
                             wk_b.to(f32))
        logits = (torch.einsum("bhc,bsc->bhs", q_abs, ckv.to(f32))
                  + torch.einsum("bhr,bsr->bhs", q_rope[:, :, 0].to(f32),
                                 krope.to(f32)))
        logits = logits * ((m.d_nope + m.d_rope) ** -0.5)
        valid = (torch.arange(ckv.shape[1], device=x.device) <= pos)
        logits = torch.where(valid[None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        lat = torch.einsum("bhs,bsc->bhc", probs, ckv.to(f32))
        wv_b = p["wv_b"].reshape(m.kv_lora, cfg.n_heads, m.d_v)
        o = torch.einsum("bhc,chd->bhd", lat, wv_b.to(f32))
        o = o.reshape(b, 1, cfg.n_heads * m.d_v).to(x.dtype)
        return o @ L.cdt(p["wo"]), (ckv, krope)

    def _block(self, p, x, cos, sin, cache=None, pos=None):
        """One transformer block. Returns (x, aux_loss, new_cache)."""
        cfg = self.cfg
        norm = L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            o, st_t = S.rwkv6_time_mix(
                p["tmix"], norm(p["norm1"], x), self._ssm_heads,
                state=None if cache is None else cache[0])
            x = x + o
            o, st_c = S.rwkv6_channel_mix(
                p["cmix"], norm(p["norm2"], x),
                state=None if cache is None else cache[1])
            x = x + o
            return x, aux, (st_t, st_c)
        if cfg.family == "hybrid":
            o, st = S.mamba2_mixer(
                p["mixer"], norm(p["norm1"], x), self._mamba_dims,
                state=cache, chunk=cfg.ssm.chunk, ssd_impl=cfg.ssd_impl,
                compute_dtype=(torch.bfloat16 if cfg.ssm_bf16
                               else torch.float32))
            return x + o, aux, st
        attn_out, kv = self._attn_block(p["attn"], norm(p["norm1"], x),
                                        cos, sin, cache=cache, pos=pos)
        x = x + attn_out
        h = norm(p["norm2"], x)
        if "moe" in p:
            b, s, d = h.shape
            out, aux = M.moe_ffn(p["moe"], h.reshape(b * s, d),
                                 _moe_cfg(cfg))
            x = x + out.reshape(b, s, d)
        else:
            x = x + (L.swiglu(p["mlp"], h) if cfg.mlp == "swiglu"
                     else L.gelu_mlp(p["mlp"], h))
        return x, aux, kv

    def _scan(self, body, carry, stacked, *per_layer):
        """The JAX ``lax.scan`` over the layer stack as a Python loop:
        ``body(carry, layer_params, *per_layer_slices) → (carry, y)``;
        returns the carry and the list of ``y``."""
        ys = []
        for i, lp in enumerate(_layers(stacked)):
            carry, y = body(carry, lp, *(a[i] for a in per_layer))
            ys.append(y)
        return carry, ys

    def _remat(self, fn, lp, x):
        """``fn(lp, x)``, a layer body over its parameters ``lp``, under
        ``cfg.remat``: "full" recomputes it in the backward pass
        (non-reentrant ``torch.utils.checkpoint``), "none" runs it plain.
        Where autograd records nothing (serving) it runs plain either way.
        ``lp`` goes in as an argument, never through a closure: the
        recompute runs after the layer loop has moved on."""
        if self.cfg.remat == "dots":
            raise NotImplementedError(_LATER["remat"])
        if self.cfg.remat == "none" or not torch.is_grad_enabled() or not (
                x.requires_grad or any(t.requires_grad for t in leaves(lp))):
            return fn(lp, x)
        return torch.utils.checkpoint.checkpoint(fn, lp, x,
                                                 use_reentrant=False)

    # ------------------------------------------------------------- forward
    def _rope_dim(self) -> int:
        """MLA ropes only its d_rope slice of each head."""
        cfg = self.cfg
        return cfg.mla.d_rope if cfg.mla is not None else cfg.d_head

    def _rope(self, s: int, device):
        cfg = self.cfg
        return (L.rope_table(s, self._rope_dim(), cfg.rope_theta,
                             device=device)
                if cfg.rope else (None, None))

    def _stacks(self, params) -> list[str]:
        """The stacked layer trees in order: the dense-FFN prologue, if
        any, then the layers."""
        return [k for k in ("prologue", "layers") if k in params]

    def backbone(self, params, batch):
        """Full-sequence forward up to (but excluding) the LM head.
        Returns (hidden (B,S,d), aux_loss)."""
        x = self.embed_inputs(params, batch)
        cos, sin = self._rope(x.shape[1], x.device)
        if self.cfg.shared_attn_every:
            x, _ = self._hybrid_forward(params, x, cos, sin)
            return x, torch.zeros((), dtype=torch.float32, device=x.device)

        def body(carry, lp):
            xx, aux = carry
            out, a = self._remat(
                lambda p, h: self._block(p, h, cos, sin)[:2], lp, xx)
            return (out, aux + a), None

        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
        for stack in self._stacks(params):
            carry, _ = self._scan(body, carry, params[stack])
        return carry

    def forward(self, params, batch):
        """Full-sequence forward → (logits (B,S,V), aux_loss)."""
        x, aux = self.backbone(params, batch)
        return self.unembed(params, x), aux

    # ------------------------------------------------------------- hybrid
    def _hybrid_forward(self, params, x, cos, sin, cache=None, pos=None):
        """Zamba2: before each segment of ``shared_attn_every`` Mamba-2
        layers, the shared block on (hidden, embeddings).  Without a cache
        (full sequence) returns (x, (mamba states, shared K/V)) stacked as
        ``init_cache`` lays them out, for S positions; with one (a decode
        step at ``pos``) writes the step's states and K/V into it in place
        and returns (x, cache)."""
        x0 = x
        mamba, attn = (None, None) if cache is None else cache
        period = self.cfg.shared_attn_every
        layers = _layers(params["layers"])
        states, kvs = [], []
        for seg in range(self.cfg.n_layers // period):
            x, kv = self._shared_block(
                params["shared_block"], x, x0, cos, sin,
                cache=None if cache is None else (attn[0][seg],
                                                  attn[1][seg]),
                pos=pos)
            kvs.append(kv)
            for i in range(seg * period, (seg + 1) * period):
                lp = layers[i]
                if cache is None:
                    x, _, st = self._remat(
                        lambda p, h: self._block(p, h, cos, sin), lp, x)
                    states.append(st)
                else:
                    conv, h = mamba[0][i], mamba[1][i]
                    x, _, (nc, nh) = self._block(lp, x, cos, sin,
                                                 cache=(conv, h))
                    conv.copy_(nc)
                    h.copy_(nh)
        if cache is not None:
            return x, cache
        return x, (_stack(states), _stack(kvs))

    def _shared_block(self, p, x, x0, cos, sin, cache=None, pos=None):
        """Zamba2's shared block: concat(hidden, embeddings) → 2d → d
        projection, attention and SwiGLU, the residual back into the
        Mamba stream.  Returns (x, kv) as ``_attn_block`` gives kv."""
        h = torch.cat([x, x0], dim=-1) @ L.cdt(p["in_proj"])
        attn_out, kv = self._attn_block(p["attn"], L.rmsnorm(p["norm1"], h),
                                        cos, sin, cache=cache, pos=pos)
        h = h + attn_out
        h = h + L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], h))
        return x + h, kv

    # ------------------------------------------------------------- training
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy over ``batch["labels"]`` plus 0.01 ×
        the MoE load-balance loss: (loss, {"ce", "aux"}).  The logits and
        the loss are in ``layers.ACCUM_DTYPE`` (float32, as in JAX)."""
        if self.cfg.loss_impl == "chunked":
            return self._loss_chunked(params, batch)
        logits, aux = self.forward(params, batch)
        labels = batch["labels"].long()
        logits = logits.to(L.ACCUM_DTYPE)
        lse = torch.logsumexp(logits, dim=-1)
        if self.cfg.loss_impl == "onehot":
            # the gold logit by a masked sum, as the JAX package takes it
            # (there: no gather across a vocab-sharded axis)
            vpos = torch.arange(logits.shape[-1], device=logits.device)
            gold = torch.sum(torch.where(vpos == labels[..., None], logits,
                                         0.0), dim=-1)
        else:
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.mean(lse - gold)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _loss_chunked(self, params, batch):
        """Vocab-streamed cross-entropy: the (B,S,V) logits are never held
        whole — logsumexp and the gold logit accumulate over chunks of
        ``cfg.loss_chunk`` vocabulary columns."""
        cfg = self.cfg
        x, aux = self.backbone(params, batch)
        norm = L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm
        xn = norm(params["final_norm"], x)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        labels = batch["labels"].long()
        acc = L.ACCUM_DTYPE
        run_max = torch.full(labels.shape, -1e30, dtype=acc, device=x.device)
        run_se = torch.zeros(labels.shape, dtype=acc, device=x.device)
        gold = torch.zeros(labels.shape, dtype=acc, device=x.device)
        for lo in range(0, cfg.vocab, cfg.loss_chunk):
            hi = min(cfg.vocab, lo + cfg.loss_chunk)
            lc = (xn @ head[:, lo:hi].to(xn.dtype)).to(acc)
            m_new = torch.maximum(run_max, lc.amax(dim=-1))
            run_se = (run_se * torch.exp(run_max - m_new)
                      + torch.exp(lc - m_new[..., None]).sum(dim=-1))
            run_max = m_new
            in_rng = (labels >= lo) & (labels < hi)
            idx = torch.clamp(labels - lo, 0, hi - lo - 1)
            gval = torch.gather(lc, -1, idx[..., None])[..., 0]
            gold = gold + torch.where(in_rng, gval, 0.0)
        ce = torch.mean(torch.log(run_se) + run_max - gold)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int):
        """dense/vlm/audio and GQA moe: (K, V), each (L, B, Hkv, max_len,
        dh) in the compute type; MLA: (c_kv (L,B,max_len,kv_lora), k_rope
        (L,B,max_len,d_rope)) in the compute type, as (prologue's, layers')
        where a dense-FFN prologue leads; ssm: ((x_prev (L,B,1,d), S
        (L,B,H,N,N)), cm_prev (L,B,1,d)) in float32, whatever
        ``max_len``; hybrid: ((conv (L,B,d_conv-1,d_inner+2N), h
        (L,B,H,N,P)) in float32, (K, V) of the shared block, each
        (n_seg,B,Hkv,max_len,dh) in the compute type)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            n = cfg.ssm.head_dim
            z = lambda *s: torch.zeros(s, dtype=L.ACCUM_DTYPE,
                                       device=self.device)
            return ((z(cfg.n_layers, batch_size, 1, cfg.d_model),
                     z(cfg.n_layers, batch_size, self._ssm_heads, n, n)),
                    z(cfg.n_layers, batch_size, 1, cfg.d_model))
        z = lambda *s: torch.zeros(s, dtype=L.COMPUTE_DTYPE,
                                   device=self.device)
        if cfg.family == "hybrid":
            di, hd, n, d_conv = self._mamba_dims
            f32 = lambda *s: torch.zeros(s, dtype=torch.float32,
                                         device=self.device)
            mamba = (f32(cfg.n_layers, batch_size, d_conv - 1, di + 2 * n),
                     f32(cfg.n_layers, batch_size, di // hd, n, hd))
            shape = (cfg.n_layers // cfg.shared_attn_every, batch_size,
                     cfg.n_kv_heads, max_len, cfg.d_head)
            return (mamba, (z(*shape), z(*shape)))
        n_dense = cfg.moe.first_k_dense if cfg.moe else 0
        ls = cfg.n_layers - n_dense
        if cfg.mla is not None:
            lat = lambda n: (z(n, batch_size, max_len, cfg.mla.kv_lora),
                             z(n, batch_size, max_len, cfg.mla.d_rope))
            return (lat(n_dense), lat(ls)) if n_dense else lat(ls)
        shape = (ls, batch_size, cfg.n_kv_heads, max_len, cfg.d_head)
        return (z(*shape), z(*shape))

    def decode_step(self, params, batch, cache, pos: int):
        """One token for every sequence. batch: {"tokens": (B,1)} or
        {"embeds": (B,1,d)}; pos: the current write position, shared by
        every sequence (unused by the ssm family, as in JAX).  Writes into
        ``cache`` and returns it."""
        x = self.embed_inputs_decode(params, batch, pos)
        if self.cfg.family == "ssm":
            return self._decode_ssm(params, x, cache)
        cos, sin = self._rope_at(pos, x.device) if self.cfg.rope \
            else (None, None)
        if self.cfg.family == "hybrid":
            # x0, the shared block's second input, is this step's own
            # embedding, as in the JAX model
            x, cache = self._hybrid_forward(params, x, cos, sin, cache, pos)
            return self.unembed(params, x), cache

        def body(carry, lp, *kv_l):
            out, _, _ = self._block(lp, carry, cos, sin, cache=kv_l,
                                    pos=pos)
            return out, None

        caches = cache if "prologue" in params else (cache,)
        for stack, kv in zip(self._stacks(params), caches, strict=True):
            x, _ = self._scan(body, x, params[stack], *kv)
        return self.unembed(params, x), cache

    def _decode_ssm(self, params, x, cache):
        (xp, st), cm = cache

        def body(carry, lp, xp_l, st_l, cm_l):
            out, _, ((nxp, nst), ncm) = self._block(
                lp, carry, None, None, cache=((xp_l, st_l), cm_l))
            xp_l.copy_(nxp)
            st_l.copy_(nst)
            cm_l.copy_(ncm)
            return out, None

        x, _ = self._scan(body, x, params["layers"], xp, st, cm)
        return self.unembed(params, x), cache

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
        dim = self._rope_dim()
        inv = 1.0 / (self.cfg.rope_theta ** (
            torch.arange(0, dim, 2, dtype=torch.float32, device=device)
            / dim))
        ang = float(pos) * inv
        return torch.cos(ang)[None], torch.sin(ang)[None]

    def prefill(self, params, batch):
        """Full-context forward that also materialises the decode cache.
        Returns (last-position logits, cache) in ``init_cache``'s layout:
        (K, V), each (L,B,Hkv,S,dh); MLA's latent caches, each (L,B,S,.),
        as (prologue's, layers') where a prologue leads; or the recurrent
        families' states (hybrid: with the shared block's K/V, each
        (n_seg,B,Hkv,S,dh))."""
        x = self.embed_inputs(params, batch)
        cos, sin = self._rope(x.shape[1], x.device)
        if self.cfg.family == "hybrid":
            x, cache = self._hybrid_forward(params, x, cos, sin)
            return self.unembed(params, x[:, -1:]), cache

        def body(carry, lp):
            out, _, kv = self._block(lp, carry, cos, sin)
            return out, kv

        caches = []
        for stack in self._stacks(params):
            x, states = self._scan(body, x, params[stack])
            caches.append(_stack(states))
        cache = tuple(caches) if "prologue" in params else caches[0]
        return self.unembed(params, x[:, -1:]), cache


def _stack(trees: list):
    """Per-layer trees of nested tuples → one tree, each leaf stacked along
    a new leading L axis (what ``lax.scan`` does with its outputs)."""
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(leaves)) for leaves in zip(*trees))
    return torch.stack(trees)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
