"""The gradient of the RWKV-6 recurrence in the port against JAX's.

``ref.rwkv6_scan_bwd`` (the plain twin of the ``rwkv6_scan_bwd`` kernel:
an explicit reverse-time loop over states recomputed from checkpoints)
against ``jax.vjp`` of ``repro.kernels.ref.rwkv6_scan`` (the ``lax.scan``
JAX differentiates) and against torch autograd of ``ref.rwkv6_scan``, at
head dims 16, 32 and 64 and S 1, 7, 77 and 128, with nonzero s0 and
ds_fin, as (BH, S, N) and as the layer's (B, H, S, N) head-split views.

The card route of ``kernels/ops.py`` runs here on the CPU: ``_on_host``
returns False, so ``rwkv6_scan`` goes through ``_Rwkv6Scan`` and the
kernels it launches (``_rwkv6_cuda``, ``_rwkv6_bwd_cuda``) are their plain
versions, each call counted as its wrapper counts a launch: a gradcheck of
the Function in float64, and the reduced RWKV-6's loss and every gradient
leaf against ``jax.value_and_grad`` of JAX's ``LM.loss_fn``.

Tolerances.  The plain backward in float32 against JAX's float32 vjp at
``F32`` (rtol 2e-4, atol 2e-5, ``tests/test_kernels.py``'s float32 bound):
both sum the same products over up to 128 steps and 64 columns in another
order, on gradients up to 330 in magnitude; the largest difference is 0.29
of the bound (N 64, S 128).  In float64 the plain
backward equals autograd of the plain forward within 1e-10.  The model at
``tests/test_torch_train.py``'s F32 (loss) and STEP (gradients).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jref
import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro.configs.base import get_config as jget_config
from repro.nn.model import LM as JLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.nn.model import LM
from repro_torch.tree import leaves

F32 = dict(rtol=2e-4, atol=2e-5)
F64 = dict(rtol=1e-10, atol=1e-10)
LOSS = dict(rtol=1e-4, atol=1e-5)               # tests/test_torch_train.py
STEP = dict(rtol=2e-4, atol=2e-5)
ARCH = "rwkv6_7b"
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def operands(seed, lead, s, n, dtype=np.float32):
    """tests/test_kernels.py's inputs (w uniform in [0.4, 0.9), s0 =
    0.1·randn), then do and ds_fin: r, k, v, w, u, s0, do, ds_fin."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(*lead, s, n) for _ in range(3))
    w = rng.rand(*lead, s, n) * 0.5 + 0.4
    u, s0 = rng.randn(*lead, n), rng.randn(*lead, n, n) * 0.1
    do, ds_fin = rng.randn(*lead, s, n), rng.randn(*lead, n, n)
    return [a.astype(dtype) for a in (r, k, v, w, u, s0, do, ds_fin)]


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
def test_plain_backward_matches_jax_vjp(n, s):
    """(BH, S, N) operands in float32 (the plain backward keeps the state
    every 64 steps: S 77 and 128 walk two chunks), against jax.vjp of the
    JAX oracle with cotangents (do, ds_fin)."""
    r, k, v, w, u, s0, do, ds_fin = operands(s + n, (3,), s, n)
    _, vjp = jax.vjp(jref.rwkv6_scan,
                     *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do),
                                        jnp.asarray(ds_fin)))]
    got = ref.rwkv6_scan_bwd(*map(torch.from_numpy,
                                  (r, k, v, w, u, s0, do, ds_fin)))
    for name, g, j in zip(NAMES, got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), j, err_msg=name, **F32)


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 7, 77, 128])
def test_plain_backward_is_autograd_of_the_plain_forward(n, s):
    """float64, the layer's call: (B, S, H, N) arrays seen as (B, H, S, N),
    u (H, N) expanded over the batch (du comes per row of state and is
    summed over the batch as autograd sums it through the expand)."""
    b, h = 2, 3
    r, k, v, w, _, _, do, _ = operands(s * n, (b, s), h, n, np.float64)
    rng = np.random.RandomState(n + 3 * s)
    u = rng.randn(h, n)
    s0, ds_fin = rng.randn(b, h, n, n) * 0.1, rng.randn(b, h, n, n)
    heads = lambda a: torch.from_numpy(a).transpose(1, 2)
    seq = [heads(a) for a in (r, k, v, w)]
    leaves_ = [t.clone().requires_grad_() for t in
               (*seq, torch.from_numpy(u), torch.from_numpy(s0))]
    o, s_fin = ref.rwkv6_scan(*leaves_[:4], leaves_[4].expand(b, h, n),
                              leaves_[5])
    want = torch.autograd.grad((o, s_fin),
                               leaves_, (heads(do), torch.from_numpy(ds_fin)))
    got = list(ref.rwkv6_scan_bwd(*seq, torch.from_numpy(u).expand(b, h, n),
                                  torch.from_numpy(s0), heads(do),
                                  torch.from_numpy(ds_fin)))
    assert got[4].shape == (b, h, n)
    got[4] = got[4].sum(0)
    for name, g, j in zip(NAMES, got, want, strict=True):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, j, msg=name, **F64)


def test_plain_backward_skips_ds0_and_takes_no_ds_fin():
    """``want_ds0=False`` gives None for ds0 and the rest unchanged;
    ``ds_fin=None`` is a zero ds_fin."""
    args = [torch.from_numpy(a) for a in operands(5, (2,), 9, 16,
                                                  np.float64)]
    zero = ref.rwkv6_scan_bwd(*args[:7], torch.zeros_like(args[7]))
    none = ref.rwkv6_scan_bwd(*args[:7], None, want_ds0=False)
    assert none[5] is None
    for a, b in zip(zero[:5], none[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture
def card_route(monkeypatch):
    """ops' card route on CPU tensors, both kernels their plain versions
    and each call counted by name."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "_on_host", lambda *t: False)
    monkeypatch.setattr(ops, "_rwkv6_cuda", counted("fwd", ref.rwkv6_scan))
    monkeypatch.setattr(ops, "_rwkv6_bwd_cuda",
                        counted("bwd", ref.rwkv6_scan_bwd))
    return calls


def card_operands(seed, b, h, s, n):
    """float64 leaves: r, k, v, w as (B, H, S, N) views of (B, S, H, N),
    u (H, N), s0 (B, H, N, N)."""
    r, k, v, w, _, _, _, _ = operands(seed, (b, s), h, n, np.float64)
    rng = np.random.RandomState(seed + 1)
    return ([torch.from_numpy(a).transpose(1, 2).requires_grad_()
             for a in (r, k, v, w)]
            + [torch.tensor(rng.randn(h, n), requires_grad=True),
               torch.tensor(rng.randn(b, h, n, n) * 0.1,
                            requires_grad=True)])


def test_rwkv6_scan_function_gradcheck(card_route):
    """Every operand's gradient through ``_Rwkv6Scan`` in float64, both
    outputs used (so ds_fin and ds0 take part), u expanded over the
    batch."""
    b, h = 2, 2
    args = card_operands(7, b, h, 5, 4)
    torch.autograd.gradcheck(
        lambda r, k, v, w, u, s0: ops.rwkv6_scan(
            r, k, v, w, u.expand(b, h, u.shape[-1]), s0), args)
    assert card_route["bwd"] > 0


def test_card_route_gradient_is_the_plain_versions(card_route):
    """One forward and one backward launch; s_fin unused (ds_fin arrives
    as None) and s0 not requiring grad (no ds0): the gradients equal
    autograd's of the plain forward, bit for bit in float64 up to the
    order of the sums (1e-10)."""
    b, h = 2, 3
    *seq, u, s0 = card_operands(8, b, h, 21, 8)
    s0 = s0.detach()
    do = torch.tensor(np.random.RandomState(9).randn(b, h, 21, 8))
    o, _ = ops.rwkv6_scan(*seq, u.expand(b, h, 8), s0)
    assert type(o.grad_fn).__name__ == "_Rwkv6ScanBackward"
    got = torch.autograd.grad(o, seq + [u], do)
    assert card_route == {"fwd": 1, "bwd": 1}
    o_plain, _ = ref.rwkv6_scan(*seq, u.expand(b, h, 8), s0)
    want = torch.autograd.grad(o_plain, seq + [u], do)
    for g, j in zip(got, want, strict=True):
        torch.testing.assert_close(g, j, **F64)


def test_card_route_without_grad_runs_the_forward_alone(card_route):
    args = [t.detach() for t in card_operands(10, 1, 2, 6, 4)]
    args[4] = args[4].expand(1, 2, 4)
    o, s_fin = ops.rwkv6_scan(*args)
    assert o.grad_fn is None and s_fin.grad_fn is None
    with torch.no_grad():
        o, _ = ops.rwkv6_scan(args[0].requires_grad_(), *args[1:])
    assert o.grad_fn is None and card_route == {"fwd": 2, "bwd": 0}


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


@functools.lru_cache(maxsize=None)
def jax_params():
    return jax.jit(JLM(jget_config(ARCH, reduced=True)).init)(
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("remat,seq", [("full", 12), ("none", 40)])
def test_rwkv6_trains_like_jax_through_the_function(card_route, f32_compute,
                                                    remat, seq):
    """The reduced RWKV-6 (2 layers, 4 heads of 32): the loss, ce, aux and
    every gradient leaf through ``_Rwkv6Scan`` against
    ``jax.value_and_grad`` of JAX's ``LM.loss_fn`` on the same numpy batch
    and converted weights, in float32 compute.  Launches: a layer's
    forward once a microbatch, once more in remat's recompute, and one
    backward; none recorded under ``no_grad``."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), remat=remat)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), remat=remat)
    jlm, lm = JLM(jcfg), LM(cfg, device="cpu")
    params = convert.from_jax_params(jax_params(), device="cpu")
    rng = np.random.RandomState(seq)
    tokens, labels = (rng.randint(0, cfg.vocab, (2, seq)).astype(np.int32)
                      for _ in range(2))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jlm.loss_fn, has_aux=True))(jax_params(), jb)
    flat = [p.requires_grad_() for p in leaves(params)]
    loss, metrics = lm.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   **LOSS)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, j in zip(names, grads, jax.tree.leaves(jgrads),
                          strict=True):
        j = np.asarray(j, np.float32)
        g = np.zeros(j.shape, np.float32) if g is None else g.numpy()
        tol = dict(STEP, atol=STEP["atol"] * max(1.0, float(np.abs(j).max())))
        np.testing.assert_allclose(g, j, err_msg=name, **tol)
    layers = cfg.n_layers
    assert card_route == {"fwd": (2 if remat == "full" else 1) * layers,
                          "bwd": layers}
    with torch.no_grad():
        loss, _ = lm.loss_fn(params, tb)
    assert loss.grad_fn is None and card_route["bwd"] == layers
