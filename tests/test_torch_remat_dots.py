"""``remat="dots"`` in the port against the JAX package's
``dots_with_no_batch_dims_saveable``: loss and gradients of the dense,
moe (``impl="sort"``), ssm and hybrid families under "dots" equal to the
port's own "full" bit for bit, and to JAX's "dots" in float32; the
products a layer keeps against the residuals JAX saves for the same block
(``jax.ad_checkpoint.print_saved_residuals``); and, counted by a dispatch
mode, the backward of a dense layer running no ``aten.mm`` but the
gradient products, while the hybrid's Mamba layers are recomputed whole,
as JAX checkpoints them under any remat.

Tolerances: against JAX, ``tests/test_torch_train.py``'s
``test_every_family_trains_like_jax``: the compute type float32 in both
packages (monkeypatched, here only), the loss at rtol 1e-4, atol 1e-5, the
gradients at rtol 2e-4, atol 2e-5 in units of each leaf's largest entry
where that exceeds 1.  Against the port's "full": exact.
"""
import dataclasses
import functools
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
import repro_torch.nn.model as model_mod
from repro.configs.base import get_config as jget_config
from repro.nn.model import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.tree import leaves

F32 = dict(rtol=1e-4, atol=1e-5)
STEP = dict(rtol=2e-4, atol=2e-5)
B, S = 2, 16
JAX_DTYPES = {"bf16": "bfloat16", "f32": "float32"}     # str_short's
FAMILIES = {"dense": "yi_6b", "moe": "deepseek_v2_lite_16b",
            "ssm": "rwkv6_7b", "hybrid": "zamba2_2_7b"}


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def configs(arch, remat):
    """The JAX and port configs, MoE with impl="sort", under ``remat``."""
    out = []
    for cfg in (jget_config(arch, reduced=True),
                get_config(arch, reduced=True)):
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="sort"))
        out.append(dataclasses.replace(cfg, remat=remat))
    return out


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.jit(JLM(jget_config(arch, reduced=True)).init)(
        jax.random.PRNGKey(0))


def batch(cfg):
    rng = np.random.RandomState(0)
    x = {k: rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def port_loss_and_grads(arch, remat):
    _, cfg = configs(arch, remat)
    lm = model_mod.LM(cfg, device="cpu")
    params = convert.from_jax_params(jax_params(arch), device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, _ = lm.loss_fn(params, batch(cfg)[1])
    return loss.detach(), torch.autograd.grad(loss, flat, allow_unused=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_trains_like_full_and_like_jax(f32_compute, family):
    arch = FAMILIES[family]
    loss, grads = port_loss_and_grads(arch, "dots")
    full_loss, full_grads = port_loss_and_grads(arch, "full")
    assert torch.equal(loss, full_loss)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(grads, full_grads, strict=True))
    jcfg, _ = configs(arch, "dots")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JLM(jcfg).loss_fn(p, b)[0]))(jax_params(arch),
                                                  batch(jcfg)[0])
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    for g, j in zip(grads, jax.tree.leaves(jgrads), strict=True):
        j = np.asarray(j, np.float32)
        g = np.zeros_like(j) if g is None else g.numpy()
        tol = dict(STEP, atol=STEP["atol"] * max(1.0, float(np.abs(j).max())))
        np.testing.assert_allclose(g, j, **tol)


def jax_saved_products(arch, capsys) -> list:
    """(dtype, rows, columns) of each residual JAX's "dots" policy saves
    for the first layer's block that is not an argument or a constant."""
    jcfg, _ = configs(arch, "dots")
    lm = JLM(jcfg)
    lp = jax.tree.map(lambda a: a[0], jax_params(arch)["layers"])
    x = jnp.ones((B, S, jcfg.d_model), JL.COMPUTE_DTYPE)
    cos, sin = (JL.rope_table(S, lm._rope_dim(), jcfg.rope_theta)
                if jcfg.rope else (None, None))
    body = jax.checkpoint(
        lambda p, h: lm._block(p, h, cos, sin)[:2],
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    capsys.readouterr()
    jax.ad_checkpoint.print_saved_residuals(body, lp, x)
    out = []
    for line in capsys.readouterr().out.splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        dtype, dims = re.match(r"(\w+)\[([\d,]*)\]", line).groups()
        dims = [int(n) for n in dims.split(",")]
        out.append((JAX_DTYPES.get(dtype, dtype), int(np.prod(dims[:-1])),
                    dims[-1]))
    return sorted(out)


def port_kept_products(arch, monkeypatch) -> list:
    """(dtype, rows, columns) of each product the port's first layer keeps
    under "dots" once its forward is done."""
    kept = []

    class Recorded(model_mod._Dots):
        def prune(self):
            super().prune()
            kept.append([t for t in self.kept if t is not None])

    monkeypatch.setattr(model_mod, "_Dots", Recorded)
    _, cfg = configs(arch, "dots")
    lm = model_mod.LM(cfg, device="cpu")
    params = convert.from_jax_params(jax_params(arch), device="cpu")
    lp = model_mod._layers(params["layers"])[0]
    for t in leaves(lp):
        t.requires_grad_()
    x = torch.ones((B, S, cfg.d_model), dtype=TL.COMPUTE_DTYPE,
                   requires_grad=True)
    cos, sin = lm._rope(S, x.device)
    lm._remat(lambda p, h: lm._block(p, h, cos, sin)[:2], lp, x)
    assert len(kept) == 1
    return sorted((str(t.dtype).removeprefix("torch."),
                   int(np.prod(t.shape[:-1])), t.shape[-1])
                  for t in kept[0])


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_dots_keeps_what_jax_saves(family, capsys, monkeypatch):
    """The same products of the same shapes and types: q, k, v, the output
    projection, gate and up for a dense block (its down projection's
    output, which only the residual add reads, is no residual); MLA's five
    projections, its output projection, the router (float32) and the
    shared experts' gate and up for a MoE block (the experts' products
    have a batch dimension, the expert); the time mix's and the channel
    mix's projections and the decay's two LoRA products (float32) for
    RWKV-6."""
    arch = FAMILIES[family]
    want = jax_saved_products(arch, capsys)
    assert want
    assert port_kept_products(arch, monkeypatch) == want


class MatmulCount(TorchDispatchMode):
    """``aten.mm`` calls that run (a product the recompute takes back from
    the forward runs in no dispatch mode below the recompute's)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def backward_products(arch, remat) -> int:
    _, cfg = configs(arch, remat)
    lm = model_mod.LM(cfg, device="cpu")
    params = convert.from_jax_params(jax_params(arch), device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, _ = lm.loss_fn(params, batch(cfg)[1])
    with MatmulCount() as count:
        torch.autograd.grad(loss, flat, allow_unused=True)
    return count.n


def test_dots_recomputes_no_dense_product():
    """The dense backward runs as many products under "dots" as with
    nothing recomputed (the gradients' alone), and fewer than under
    "full", which recomputes 6 of each layer's 7 (the down projection's
    output is never needed)."""
    dots = backward_products("yi_6b", "dots")
    assert dots == backward_products("yi_6b", "none")
    n_layers = get_config("yi_6b", reduced=True).n_layers
    assert backward_products("yi_6b", "full") == dots + 6 * n_layers


def test_hybrid_dots_recomputes_the_mamba_layers():
    """Under "dots" the hybrid recomputes each Mamba layer's input
    projection, as under "full" (JAX checkpoints the Mamba bodies whole
    whenever remat is on); with remat off nothing is recomputed."""
    dots = backward_products("zamba2_2_7b", "dots")
    assert dots == backward_products("zamba2_2_7b", "full")
    n_layers = get_config("zamba2_2_7b", reduced=True).n_layers
    assert dots == backward_products("zamba2_2_7b", "none") + n_layers
