"""The gradient of flash attention in the port against JAX's.

``ref.flash_attention_bwd`` (the plain twin of the ``flash_attention_bwd``
kernel) and autograd through ``ops.flash_attention`` on the CPU, against
``jax.vjp`` of ``repro.nn.layers.attend_flash`` (the function JAX trains
through) on the same numpy inputs: head dims (D, Dv) of the dense models
(32, 64), MLA (192, 128) and Zamba2 (80, 80), causal and full, GQA groups
1 and 4, S 64 and 96.  ``attend_flash`` runs its online-softmax path in
chunks of 32.

Tolerance: rtol 3e-5, atol 3e-6, outputs and gradients.  At these
inputs (gradients up to 7 in magnitude, entries near 0 that are sums of a
few hundred terms near 1, the D = 192 outputs sums of 192-term scores)
float32 rounding alone exceeds rtol 1e-5, atol 1e-6.  Measured against
the float64 answer in units of that bound, JAX's own gradients lie up to
1.01 from it and the plain backward's (Δ = Σ P·dP, the scale applied
after the sums, as the kernel has them) up to 1.45, autograd's too at
S = 96 with four heads a group; so the two packages may differ by up to
their sum, 2.46 (1.57 is the largest seen), and 3 × that bound holds it.
The plain backward in float64 must equal autograd of the float64 forward
(1e-12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
from repro_torch.kernels import ops, ref

F32 = dict(rtol=3e-5, atol=3e-6)
DIMS = [(32, 32), (64, 64), (192, 128), (80, 80)]


def operands(seed, b, hq, hkv, s, d, dv):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv), (b, hq, s, dv))]


def jax_grads(q, k, v, do, causal):
    out, vjp = jax.vjp(lambda q, k, v: JL.attend_flash(
        q, k, v, chunk=32, causal=causal), *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize("d,dv", DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s", [64, 96])
def test_flash_gradient_matches_jax(d, dv, causal, group, s):
    q, k, v, do = operands(d + dv + s + group, 2, 2 * group, 2, s, d, dv)
    jout, jgrads = jax_grads(q, k, v, do, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **F32)
    autograd = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    plain = ref.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal=causal)
    for name, a, p, j in zip("qkv", autograd, plain, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), err_msg=name,
                                   **F32)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), err_msg=name,
                                   **F32)


def test_plain_backward_keeps_float64_and_types():
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in operands(0, 1, 4, 2, 40, 32, 32))
    grads = ref.flash_attention_bwd(q, k, v, do)
    assert all(g.dtype == torch.float64 for g in grads)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*leaves), leaves, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.fixture
def card_route(monkeypatch):
    """ops' card route on CPU tensors: the kernels replaced by their plain
    versions, each call counted as its wrapper counts a launch."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, causal=True, scale=None):
        calls["fwd"] += 1
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)

    def bwd(q, k, v, do, causal=True, scale=None):
        calls["bwd"] += 1
        assert do.stride(-1) == 1 and q.dtype == do.dtype
        return ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       scale=scale)

    monkeypatch.setattr(ops, "_on_host", lambda *t: False)
    monkeypatch.setattr(ops, "_flash_cuda", fwd)
    monkeypatch.setattr(ops, "_flash_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_flash_takes", lambda t: t.stride(-1) == 1)
    return calls


@pytest.mark.parametrize("bf16_scores", [False, True])
def test_card_route_is_an_autograd_function(card_route, bf16_scores):
    """One forward and one backward launch; the gradient of the float32-P
    function at the operands the kernel was given (rounded to bf16 when
    ``bf16_scores``), cast back to the operands' type; a dO that is a
    transposed view reaches the kernel with unit last stride."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   operands(1, 2, 8, 2, 48, 64, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, bf16_scores=bf16_scores)
    assert out.dtype == torch.float32
    do_view = do.transpose(2, 3).contiguous().transpose(2, 3)
    got = torch.autograd.grad(out, leaves, do_view)
    assert card_route == {"fwd": 1, "bwd": 1}
    given = [t.to(torch.bfloat16) if bf16_scores else t for t in (q, k, v)]
    want = ref.flash_attention_bwd(*given, do.to(given[0].dtype))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w.float(), rtol=0, atol=0)


def test_card_route_without_grad_runs_the_forward_alone(card_route):
    q, k, v, _ = (torch.from_numpy(a) for a in operands(2, 1, 4, 4, 16, 32,
                                                       32))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None and card_route == {"fwd": 1, "bwd": 0}
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    assert card_route == {"fwd": 2, "bwd": 0}


def guarded_calls(t):
    """Each kernel's ops entry point with its float operand ``t``."""
    i32 = lambda n: torch.arange(n, dtype=torch.int32)
    return {
        "relational_matmul": lambda: ops.relational_matmul(
            i32(4), i32(4), torch.ones(4), t, 4),
        "fused_sigmoid_matmul": lambda: ops.fused_sigmoid_matmul(t, t),
        "onehot_embed": lambda: ops.onehot_embed(i32(4), t),
        "moe_dispatch": lambda: ops.moe_dispatch(t, i32(4), torch.ones(4)),
        "moe_combine": lambda: ops.moe_combine(t, i32(4), 4),
        "rwkv6_scan": lambda: ops.rwkv6_scan(
            t[None, None], t[None, None], t[None, None], t[None, None],
            t[0][None], t[None]),
    }


SLICES = {"relational_matmul": "MoE training", "moe_dispatch": "MoE training",
          "moe_combine": "MoE training", "rwkv6_scan": "RWKV-6 training",
          "fused_sigmoid_matmul": "own IR", "onehot_embed": "no gradient"}


@pytest.mark.parametrize("kernel", sorted(SLICES))
def test_kernels_without_a_backward_raise_before_they_launch(monkeypatch,
                                                             kernel):
    """With the card route taken (``_on_host`` False) and an operand that
    requires grad, each wrapper raises NotImplementedError naming where its
    backward comes from, and no kernel is called; without grad (or under
    ``no_grad``) the same call reaches the kernel."""
    launched = []
    for name in ("_relmm_cuda", "_fsm_cuda", "_embed_cuda", "_moe_cuda",
                 "_rwkv6_cuda"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **kw: (
            launched.append(_n), torch.zeros(()))[1])
    monkeypatch.setattr(ops, "_on_host", lambda *t: False)
    t = torch.ones(4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match=SLICES[kernel]):
        guarded_calls(t)[kernel]()
    assert launched == []
    with torch.no_grad():
        guarded_calls(t)[kernel]()
    guarded_calls(t.detach())[kernel]()
    assert len(launched) == 2
