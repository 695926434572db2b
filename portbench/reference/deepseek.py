"""DeepSeek-V2's MLA + MoE language model and its training step, in plain
PyTorch, over the parameter tree of ``inputs.lm_layout``.

The model as the port runs it: the configuration file's values, except
where its ``departures`` name a fault of the port, whose ``port`` value
this reference takes (``rope_scaling`` null, ``norm_topk_prob`` true,
``seq_aux`` false: a token-level load-balance loss, ``aux_loss_alpha``
0.01); ``Model`` refuses a file whose values it does not implement:

* the embedding row of each token, in the compute type (bf16);
* each layer: x += MLA(rmsnorm(x)); x += FFN(rmsnorm(x)), the first
  ``first_k_dense_replace`` layers with a SwiGLU FFN, the rest MoE;
* MLA (no query compression): q = x Wq split into (nope, rope) parts; the
  latent c = rmsnorm(x Wkv_a); k = (c Wk_b, rope(x Wk_rope) shared by the
  heads); v = c Wv_b; causal softmax attention with scale (nope + rope) **
  -0.5; rope rotates halves of the rope part, angles pos / theta ** (2i /
  rope);
* MoE: softmax router over the experts in float32, the top-k gates
  renormalised to sum to 1; tokens in groups of ``moe_group_size`` (or
  all of them where they are fewer or do not divide into groups), each
  expert taking at most ``capacity`` = max(8, ceil8(int(group k
  capacity_factor / E))) assignments of a group, rank-major (every token's
  first choice before any second choice, in token order), the rest
  dropped; experts SwiGLU; the kept gated outputs summed in float32; the
  shared experts one SwiGLU of width ``n_shared_experts`` x
  ``moe_intermediate_size``; aux = E sum_e mean_prob_e mean_count_e / k;
* loss = mean cross-entropy of the float32 logits + ``aux_loss_alpha`` x
  the layers' aux.

Products take bf16 operands (float32 parameters cast at each use) and
sum in float32 into bf16; norms, softmax and the loss are float32.  The
step: microbatches one after another, gradients summed in float32 and
averaged, clipped to their global norm, then AdamW, as the traffic file
states."""
from __future__ import annotations

import gc

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import inputs
from .numerics import exact_float32, fp8, product

BF16 = torch.bfloat16
#: heads whose scores one attention block holds
HEAD_BLOCK = 4


def _rms(w, x, eps):
    xf = x.double() if x.dtype == torch.float64 else x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
            * w).to(x.dtype)


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


#: the values this reference implements, where the file may state others
IMPLEMENTS = {"norm_topk_prob": True, "rope_scaling": None, "seq_aux": False}


def as_run(c: dict, key: str):
    """The value the port runs for ``key``: the ``port`` value of a
    departure, else the file's."""
    dep = c.get("departures", {}).get(key)
    return dep["port"] if isinstance(dep, dict) else c[key]


class Model:
    def __init__(self, c: dict, precision: str = "bf16"):
        for key, value in IMPLEMENTS.items():
            if as_run(c, key) != value:
                raise ValueError(f"the reference implements {key} = "
                                 f"{value!r}, the port runs "
                                 f"{as_run(c, key)!r}")
        self.c = c
        self.precision = precision
        self.mm = product(precision)
        self.eps = c["rms_norm_eps"]
        self.acc = torch.float64 if precision == "float64" else torch.float32
        self.dtype = {"float64": torch.float64, "float32": torch.float32,
                      "tf32": torch.float32}.get(precision, BF16)

    # -- attention --------------------------------------------------------
    def _attend(self, q, k, v):
        """Causal softmax attention of q, k (B, H, S, D) and v (B, H, S,
        Dv) in float32 from the compute-type values, a block of heads at a
        time."""
        s, d = q.shape[2], q.shape[3]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        outs = []
        for h0 in range(0, q.shape[1], HEAD_BLOCK):
            qb, kb, vb = (t[:, h0:h0 + HEAD_BLOCK].to(self.acc)
                          for t in (q, k, v))
            if self.precision == "fp8":
                qb, kb, vb = (fp8(t).float() for t in (qb, kb, vb))
            sc = (qb @ kb.transpose(-1, -2)) * d ** -0.5
            p = torch.softmax(sc.masked_fill(mask, float("-inf")), dim=-1)
            if self.precision == "fp8":
                p = fp8(p).float()
            outs.append((p @ vb).to(q.dtype))
        return torch.cat(outs, dim=1)

    def mla(self, p, x, cos, sin):
        c, mm = self.c, self.mm
        b, s, _ = x.shape
        h, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
        q = mm(x, p["wq"]).view(b, s, h, dn + dr).transpose(1, 2)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
        lat = _rms(p["kv_a_norm"]["w"], mm(x, p["wkv_a"]), self.eps)
        k_nope = mm(lat, p["wk_b"]).view(b, s, h, dn).transpose(1, 2)
        k_rope = _rope(mm(x, p["wk_rope"])[:, None], cos, sin)
        k = torch.cat([k_nope, k_rope.expand(b, h, s, dr)], dim=-1)
        v = mm(lat, p["wv_b"]).view(b, s, h, dv).transpose(1, 2)
        o = self._attend(q, k, v)
        return mm(o.transpose(1, 2).reshape(b, s, h * dv), p["wo"])

    # -- feed-forward -----------------------------------------------------
    def swiglu(self, p, x):
        mm = self.mm
        return mm(mm(x, p["wi"]) * F.silu(mm(x, p["wg"])), p["wo"])

    def moe(self, p, x):
        """x (T, d) -> (out (T, d), aux)."""
        c, mm = self.c, self.mm
        t, d = x.shape
        e, k = c["n_routed_experts"], c["num_experts_per_tok"]
        g = min(c["moe_group_size"], t)
        g = g if t % g == 0 else t
        n_groups = t // g
        xg = x.view(n_groups, g, d)
        probs = torch.softmax(xg.to(self.acc) @ p["router"].to(self.acc),
                              dim=-1)
        top, idx = torch.topk(probs, k, dim=-1)                  # (G, g, k)
        gates = top / top.sum(-1, keepdim=True)
        count = F.one_hot(idx, e).float().sum(-2).mean((0, 1))
        aux = e * (probs.mean((0, 1)) * count).sum() / k
        cap = int(g * k * c["capacity_factor"] / e)
        cap = max(8, -(-cap // 8) * 8)
        # each assignment's rank inside its expert, rank-major
        order = idx.transpose(1, 2).reshape(n_groups, k * g)
        hot = F.one_hot(order, e)
        rank = ((hot.cumsum(1) * hot).sum(-1) - 1).view(n_groups, k, g)
        rank = rank.transpose(1, 2)                              # (G, g, k)
        keep = rank < cap
        group = torch.arange(n_groups, device=x.device)[:, None, None]
        slot = (idx * n_groups + group) * cap + rank             # (e, G, c)
        token = (group * g + torch.arange(g, device=x.device)[None, :, None]
                 ).expand(n_groups, g, k)
        buf = x.new_zeros(e * n_groups * cap, d)
        buf = buf.index_put((slot[keep],), x[token[keep]])
        buf = buf.view(e, n_groups * cap, d)
        y = mm(mm(buf, p["wi"]) * F.silu(mm(buf, p["wg"])), p["wo"])
        y = y.reshape(e * n_groups * cap, d)
        picked = y[torch.where(keep, slot, 0)].to(self.acc)     # (G,g,k,d)
        w = torch.where(keep, gates, 0.0)[..., None]
        out = (picked * w).sum(2).to(x.dtype).view(t, d)
        return out + self.swiglu(p["shared"], x), aux

    # -- the model --------------------------------------------------------
    def _layer(self, p, x, cos, sin, moe: bool):
        x = x + self.mla(p["attn"], _rms(p["norm1"]["w"], x, self.eps),
                         cos, sin)
        h = _rms(p["norm2"]["w"], x, self.eps)
        if moe:
            b, s, d = h.shape
            out, aux = self.moe(p["moe"], h.reshape(b * s, d))
            return x + out.view(b, s, d), aux
        return x + self.swiglu(p["mlp"], h), torch.zeros((), device=x.device)

    def loss(self, params, tokens, labels):
        c = self.c
        s = tokens.shape[1]
        dr = c["qk_rope_head_dim"]
        inv = 1.0 / (c["rope_theta"] ** (torch.arange(
            0, dr, 2, dtype=torch.float32, device=tokens.device) / dr))
        ang = torch.arange(s, dtype=torch.float32,
                           device=tokens.device)[:, None] * inv[None]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x = params["embed"][tokens.long()].to(self.dtype)
        aux = torch.zeros((), device=x.device)
        for stack, moe in (("prologue", False), ("layers", True)):
            if stack not in params:
                continue
            per_layer = _unbind(params[stack])
            for lp in per_layer:
                x, a = torch.utils.checkpoint.checkpoint(
                    lambda lp_, x_, m=moe: self._layer(lp_, x_, cos, sin, m),
                    lp, x, use_reentrant=False)
                aux = aux + a
        h = _rms(params["final_norm"]["w"], x, self.eps)
        logits = self.mm(h, params["lm_head"]).to(self.acc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean() + as_run(c, "aux_loss_alpha") * aux


def _unbind(tree):
    """Each layer's view of a stacked tree (every leaf unbound once)."""
    parts = {k: (_unbind(v) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def leaf_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaf_items(v, name + ".")
        else:
            yield name, v


def train(c: dict, traffic: dict, seed: int, device, steps: int = 3,
          precision: str = "bf16") -> dict:
    """The first ``steps`` training steps from the weights and tokens of
    ``seed``: {"loss": [each step's loss], "grad1": {leaf: norm of the
    first step's clipped gradient}, "change": {leaf: norm of the change
    after ``steps``}}."""
    model = Model(c, precision)
    gen = inputs.generator(seed, device)
    params = inputs.lm_weights(c, gen)
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
                    acc.add_(g.float())
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
                t = step + 1
                b1t, b2t = 1.0 - b1 ** t, 1.0 - b2 ** t
                for p, g, mm_, vv in zip(flat, grads, m, v):
                    mm_.mul_(b1).add_((1 - b1) * g)
                    vv.mul_(b2).add_((1 - b2) * g * g)
                    upd = (mm_ / b1t) / ((vv / b2t).sqrt() + traffic["adam_eps"])
                    p.sub_(traffic["lr"] * (upd + traffic["weight_decay"] * p))
            del grads
            gc.collect()
    del m, v
    start = dict(leaf_items(inputs.lm_weights(c, inputs.generator(seed,
                                                                  device))))
    change = {n: float(torch.linalg.vector_norm(p - start[n]))
              for n, p in zip(names, flat)}
    return {"loss": losses, "grad1": grad1, "change": change}


def _rebuild(tree, by_name, prefix=""):
    return {k: (_rebuild(v, by_name, f"{prefix}{k}.") if isinstance(v, dict)
                else by_name[f"{prefix}{k}"])
            for k, v in tree.items()}
