"""Zamba2 as published, in plain PyTorch, and its training step: the plain
reference of the Zamba2 cells, over the parameter tree of
``zamba2_inputs.layout``.  It imports nothing of the program and no
kernel.  The equations are those of ``transformers``'
``models/zamba2/modeling_zamba2.py`` (arXiv:2411.15242; the SSD of
arXiv:2405.21060) with the configuration file's values:

* x0 = the embedding row of each token, in the compute type;
* layer i: x = x + mamba(rmsnorm(x + t_i)), t_i = 0 but for a hybrid
  layer (use j, block j mod ``num_mem_blocks``), where t_i = linear_j(
  block(x, x0, adapter_j));
* block: h = rmsnorm(concat(x, x0)) over 2d; q, k, v = h Wq, h Wk, h Wv
  in heads of 2d / heads with rope (rotate-half, theta ``rope_theta``) on
  every dim; causal softmax at scale (head dim / 2) ** -0.5; h = o Wo; h
  = rmsnorm(h); (g, u) = h Wgu + h A_j B_j; out = (gelu(g) u) Wdown, exact
  GELU; no residual;
* mamba: (z, xBC, dt) = x Win; xBC = silu(causal depthwise conv (width
  d_conv) + bias); x, B, C split, B and C in ``mamba_ngroups`` groups, head
  h reading group h // (H / G); dt = softplus(dt + dt_bias), unclamped
  (``time_step_limit`` null); A = -exp(A_log); the SSD (h_t = exp(dt_t A)
  h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t) by the exact chunked (block)
  decomposition of ``chunk_size`` tokens, written here apart from the
  program's: one chunk after another, the state carried between; y = y + D
  x; the gated RMSNorm of y silu(z) in ``mamba_ngroups`` groups, eps 1e-5;
  out = y Wout;
* logits = rmsnorm(x) embedᵀ (tied), loss = mean cross-entropy.

Precision, as ``deepseek.py`` takes it: products from operands in the
compute type (bf16 at the configuration's precision, through
``numerics.product``), norms, softmax, the SSD and the loss in float32,
the activations between in the compute type.  ``precision="fp8"`` is the
control: the products and the attention's operands in fp8.  Departures
from the source: none in the equations; the gated norm's weight is applied
in float32 before the cast (the source casts, then multiplies), as the
port does; the conv runs in float32 on the compute-type values."""
from __future__ import annotations

import gc

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import inputs, sampled, zamba2_inputs
from .deepseek import _rebuild, _unbind, leaf_items
from .numerics import exact_float32, fp8, product

#: heads whose scores one attention block holds
HEAD_BLOCK = 4
#: the gated norm's epsilon (``Zamba2RMSNormGated``'s, fixed in the source)
GATED_EPS = 1e-5

#: values of the configuration file that this reference does not implement
REFUSES = {"use_shared_attention_adapter": True, "add_bias_linear": True,
           "use_long_context": True}


def _rms(w, x, eps):
    xf = x.double() if x.dtype == torch.float64 else x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            * w).to(x.dtype)


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def tied(c: dict) -> bool:
    return c.get("assumed", {}).get("tie_word_embeddings",
                                    c.get("tie_word_embeddings", True))


def ssd(x, dt, a, b_g, c_g, chunk: int):
    """y (B, S, H, P) of the SSD recurrence, float32 (float64 stays), by
    chunks: within a chunk y = (C Bᵀ ∘ decay) (dt x) plus C h_prev scaled
    by the decay from the chunk's start; the state then h = decay(chunk) h
    + Σ_s decay(s → end) B_s (dt_s x_s)ᵀ.  x (B,S,H,P), dt (B,S,H), a (H,)
    = A, b_g / c_g (B,S,G,N)."""
    bsz, s, h, p = x.shape
    g, n = b_g.shape[2], b_g.shape[3]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    rep = h // g
    bh = b_g.to(acc).repeat_interleave(rep, dim=2)           # (B,S,H,N)
    ch = c_g.to(acc).repeat_interleave(rep, dim=2)
    xdt = x.to(acc) * dt.to(acc)[..., None]
    la = dt.to(acc) * a.to(acc)                               # log decay
    state = torch.zeros(bsz, h, n, p, dtype=acc, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(s, c0 + chunk))
        cum = torch.cumsum(la[:, sl], dim=1)                  # (B,C,H)
        t = cum.shape[1]
        # decay from key s to query l within the chunk, 0 above the diagonal
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (B,l,s,H)
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        w = torch.exp(seg.masked_fill(~causal, float("-inf")))
        scores = torch.einsum("blhn,bshn->blsh", ch[:, sl], bh[:, sl]) * w
        y = torch.einsum("blsh,bshp->blhp", scores, xdt[:, sl])
        y = y + torch.einsum("blhn,bhnp->blhp", ch[:, sl], state) \
            * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum)                 # (B,C,H)
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bshn,bshp->bhnp", bh[:, sl] * to_end[..., None], xdt[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1)


class Model:
    def __init__(self, c: dict, precision: str = "bf16"):
        for key, value in REFUSES.items():
            if c.get(key) == value:
                raise ValueError(f"the reference does not implement {key} = "
                                 f"{value!r}")
        if c.get("time_step_limit") not in (None, [0.0, float("inf")]):
            raise ValueError("the reference runs dt unclamped")
        self.c = c
        self.precision = precision
        self.mm = product(precision)
        self.eps = c["rms_norm_eps"]
        self.acc = torch.float64 if precision == "float64" else torch.float32
        self.dtype = {"float64": torch.float64, "float32": torch.float32,
                      "tf32": torch.float32}.get(precision, torch.bfloat16)
        self.hybrid = {layer: j for j, layer in
                       enumerate(c["hybrid_layer_ids"])}

    # -- the shared block -------------------------------------------------
    def _attend(self, q, k, v):
        s, d = q.shape[2], q.shape[3]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        outs = []
        for h0 in range(0, q.shape[1], HEAD_BLOCK):
            qb, kb, vb = (t[:, h0:h0 + HEAD_BLOCK].to(self.acc)
                          for t in (q, k, v))
            if self.precision == "fp8":
                qb, kb, vb = (fp8(t).float() for t in (qb, kb, vb))
            sc = (qb @ kb.transpose(-1, -2)) * (d / 2) ** -0.5
            pr = torch.softmax(sc.masked_fill(mask, float("-inf")), dim=-1)
            if self.precision == "fp8":
                pr = fp8(pr).float()
            outs.append((pr @ vb).to(q.dtype))
        return torch.cat(outs, dim=1)

    def block(self, p, use, x, x0, cos, sin):
        c, mm = self.c, self.mm
        b, s, d = x.shape
        heads, hd = c["num_attention_heads"], c["attention_head_dim"]
        kvh = c["num_key_value_heads"]
        h = _rms(p["norm1"]["w"], torch.cat([x, x0], dim=-1), self.eps)
        q = mm(h, p["attn"]["wq"]).view(b, s, heads, hd).transpose(1, 2)
        k = mm(h, p["attn"]["wk"]).view(b, s, kvh, hd).transpose(1, 2)
        v = mm(h, p["attn"]["wv"]).view(b, s, kvh, hd).transpose(1, 2)
        if c["use_mem_rope"]:
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        rep = heads // kvh
        k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        o = self._attend(q, k, v).transpose(1, 2).reshape(b, s, heads * hd)
        h = _rms(p["norm2"]["w"], mm(o, p["attn"]["wo"]), self.eps)
        gu = mm(h, p["mlp"]["gate_up"])
        if c["use_shared_mlp_adapter"]:
            gu = gu + mm(mm(h, use["adapter"]["a"]), use["adapter"]["b"])
        g, u = gu.chunk(2, dim=-1)
        act = (F.gelu(g.to(self.acc)) * u.to(self.acc)).to(self.dtype)
        return mm(mm(act, p["mlp"]["down"]), use["linear"])

    # -- the Mamba-2 mixer ------------------------------------------------
    def mixer(self, p, x):
        c, mm = self.c, self.mm
        b, s, d = x.shape
        di = c["mamba_expand"] * d
        heads, hp = c["n_mamba_heads"], c["mamba_headdim"]
        g, n = c["mamba_ngroups"], c["mamba_d_state"]
        k = c["mamba_d_conv"]
        proj = mm(x, p["in_proj"])
        z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, heads], dim=-1)
        w = p["conv_w"].to(self.acc).t()[:, None, :]          # (ch, 1, k)
        conv = F.conv1d(F.pad(xbc.to(self.acc).transpose(1, 2), (k - 1, 0)),
                        w, p["conv_b"].to(self.acc) if c["use_conv_bias"]
                        else None, groups=w.shape[0])
        xbc = F.silu(conv).transpose(1, 2).to(self.dtype)
        xs, bg, cg = torch.split(xbc, [di, g * n, g * n], dim=-1)
        dtf = F.softplus(dt.to(self.acc) + p["dt_bias"].to(self.acc))
        a = -torch.exp(p["a_log"].to(self.acc))
        xh = xs.view(b, s, heads, hp)
        y = ssd(xh, dtf, a, bg.view(b, s, g, n), cg.view(b, s, g, n),
                c["chunk_size"])
        y = y + p["d_skip"].to(self.acc)[:, None] * xh.to(self.acc)
        gate = F.silu(z.to(self.acc))
        hg = (y.reshape(b, s, di) * gate).view(b, s, g, di // g)
        hg = hg * torch.rsqrt((hg * hg).mean(-1, keepdim=True) + GATED_EPS)
        y = (hg.reshape(b, s, di) * p["norm"]["w"]).to(self.dtype)
        return mm(y, p["out_proj"])

    # -- the model --------------------------------------------------------
    def _layer(self, lp, x, t):
        h = x if t is None else x + t
        return x + self.mixer(lp["mixer"], _rms(lp["norm1"]["w"], h,
                                                self.eps))

    def loss(self, params, tokens, labels):
        logits = self.logits(params, tokens)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()

    def logits(self, params, tokens):
        """(B, S, V) logits, in float32 (float64 at that precision)."""
        c = self.c
        s = tokens.shape[1]
        dr = c["attention_head_dim"]
        inv = 1.0 / (c["rope_theta"] ** (torch.arange(
            0, dr, 2, dtype=torch.float32, device=tokens.device) / dr))
        ang = torch.arange(s, dtype=torch.float32,
                           device=tokens.device)[:, None] * inv[None]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x0 = params["embed"][tokens.long()].to(self.dtype)
        x = x0
        blocks = _unbind(params["shared_blocks"])
        uses = _unbind(params["hybrid"])
        ckpt = torch.utils.checkpoint.checkpoint
        for i, lp in enumerate(_unbind(params["layers"])):
            j = self.hybrid.get(i)
            t = None
            if j is not None:
                t = ckpt(lambda bp, up, x_, x0_: self.block(
                    bp, up, x_, x0_, cos, sin),
                    blocks[j % c["num_mem_blocks"]], uses[j], x, x0,
                    use_reentrant=False)
            x = ckpt(self._layer, lp, x, t, use_reentrant=False)
        h = _rms(params["final_norm"]["w"], x, self.eps)
        head = params["embed"].t() if tied(c) else params["lm_head"]
        return self.mm(h, head).to(self.acc)


def train(c: dict, traffic: dict, seed: int, device, steps: int = 3,
          precision: str = "bf16", weights=None) -> dict:
    """The first ``steps`` training steps from the weights and tokens of
    ``seed`` (``weights``: a maker in ``zamba2_inputs.weights``' place, for
    the tests): {"loss": [each step's loss], "grad1": {leaf: norm of the
    first step's clipped gradient}, "change": {leaf: norm of the change
    after ``steps``}}.  The step as ``deepseek.train`` takes it:
    microbatches one after another, gradients summed in float32 and
    averaged, clipped to their global norm, then AdamW.  "sample1" holds
    the first step's clipped gradient at ``sampled.positions``."""
    make = weights or zamba2_inputs.weights
    model = Model(c, precision)
    params = make(c, inputs.generator(seed, device))
    names, flat = zip(*leaf_items(params))
    stream = inputs.TokenStream(c["vocab_size"], traffic["seq_len"],
                                traffic["global_batch"], seed, device)
    n_micro = traffic["microbatches"]
    b1, b2 = traffic["adam_b1"], traffic["adam_b2"]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, grad1 = [], {}
    with exact_float32():
        for step in range(steps):
            batch = stream.batch_at(step)
            rows = batch["tokens"].shape[0] // n_micro
            grads = [torch.zeros_like(p) for p in flat]
            total = 0.0
            for i in range(n_micro):
                tracked = [p.detach().requires_grad_() for p in flat]
                tree = _rebuild(params, dict(zip(names, tracked)))
                sl = slice(i * rows, (i + 1) * rows)
                loss = model.loss(tree, batch["tokens"][sl],
                                  batch["labels"][sl])
                for acc, g in zip(grads, torch.autograd.grad(loss, tracked)):
                    acc.add_(g.to(acc.dtype))
                total += float(loss.detach())
                del loss, tracked, tree
            losses.append(total / n_micro)
            with torch.no_grad():
                for g in grads:
                    g.div_(n_micro)
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(traffic["clip_norm"] / (norm + 1e-9),
                                    max=1.0)
                for g in grads:
                    g.mul_(scale)
                if step == 0:
                    grad1 = {n: float(torch.linalg.vector_norm(g))
                             for n, g in zip(names, grads)}
                    sample1 = sampled.sample(zip(names, grads))
                t = step + 1
                b1t, b2t = 1.0 - b1 ** t, 1.0 - b2 ** t
                for p, g, mm_, vv in zip(flat, grads, m, v):
                    mm_.mul_(b1).add_((1 - b1) * g)
                    vv.mul_(b2).add_((1 - b2) * g * g)
                    upd = (mm_ / b1t) / ((vv / b2t).sqrt()
                                         + traffic["adam_eps"])
                    p.sub_(traffic["lr"] * (upd + traffic["weight_decay"] * p))
            del grads
            gc.collect()
    del m, v
    start = dict(leaf_items(make(c, inputs.generator(seed, device))))
    change = {n: float(torch.linalg.vector_norm(p - start[n]))
              for n, p in zip(names, flat)}
    return {"loss": losses, "grad1": grad1, "sample1": sample1,
            "change": change}
