"""Twins of the JAX package's RWKV-6 layers and of its ``rwkv6_scan``
kernel tests, for the port: the same numpy inputs through ``repro.nn.ssm``
/ ``repro.kernels`` and ``repro_torch.nn.ssm`` / ``repro_torch.kernels`` on
the CPU.

The port's recurrence is ``ops.rwkv6_scan``; on the CPU it is the plain
version, held here against the JAX oracle ``ref.rwkv6_scan`` and the Pallas
kernel in interpret mode at ``tests/test_kernels.py``'s shapes and
tolerance (``rtol=atol=3e-4``), and at ragged S.  The layers are held
against JAX's on converted parameters in float32 compute (``rtol=2e-4,
atol=2e-5``) and in bf16 compute (the model tests' ``rtol=0.08,
atol=0.05``), with and without an incoming state; the last three tests are
the port's twins of ``tests/test_ssm.py::TestRWKV6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
import repro_torch.nn.layers as TL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import ssm as JS
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as scan_mod
from repro_torch.nn import ssm as TS

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)                 # test_kernels.py
DTYPES = {"float32": (jnp.float32, torch.float32, dict(rtol=2e-4, atol=2e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16,
                       dict(rtol=0.08, atol=0.05))}
D, HEADS, FF, LORA = 32, 4, 64, 8


def scan_inputs(bh, s, n, seed=0):
    """test_kernels.py's inputs: w uniform in [0.4, 0.9), s0 = 0.1·randn."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(bh, s, n) for _ in range(3)]
    arrays += [rng.rand(bh, s, n) * 0.5 + 0.4, rng.randn(bh, n),
               rng.randn(bh, n, n) * 0.1]
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def close(t: torch.Tensor, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the recurrence: plain version vs the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,n,blk", [(2, 32, 16, 16), (4, 64, 32, 32),
                                        (1, 128, 64, 64)])
def test_plain_scan_matches_jax_ref_and_pallas(bh, s, n, blk):
    j_in, t_in = scan_inputs(bh, s, n)
    o, s_fin = ops.rwkv6_scan(*t_in)
    assert o.shape == (bh, s, n) and s_fin.shape == (bh, n, n)
    assert o.dtype == s_fin.dtype == torch.float32
    for what, (jo, js) in {
            "jax ref": jref.rwkv6_scan(*j_in),
            "pallas": jops.rwkv6_scan(*j_in, use_pallas=True, blk_t=blk)
    }.items():
        close(o, jo, SCAN_TOL, f"o vs {what}")
        close(s_fin, js, SCAN_TOL, f"s_fin vs {what}")


@pytest.mark.parametrize("s", [1, 7, 77])
def test_plain_scan_ragged_seq(s):
    """No divisibility rule (the Pallas kernel's S % blk_t)."""
    j_in, t_in = scan_inputs(3, s, 32, seed=s)
    o, s_fin = ref.rwkv6_scan(*t_in)
    jo, js = jref.rwkv6_scan(*j_in)
    close(o, jo, SCAN_TOL, "o")
    close(s_fin, js, SCAN_TOL, "s_fin")


def test_plain_scan_takes_batch_and_head_axes():
    """(B, H, S, N) views of (B, S, H, N) data, u expanded over the batch:
    the layer's call gives the (BH, S, N) call's numbers."""
    b, h, s, n = 2, 3, 9, 16
    _, (r, k, v, w, u, s0) = scan_inputs(b * h, s, n, seed=1)
    bshn = lambda t: t.reshape(b, h, s, n).transpose(1, 2).contiguous()
    heads = lambda t: bshn(t).transpose(1, 2)
    u_h = u.reshape(b, h, n)[0]
    u_bh = u_h.expand(b, h, n).reshape(b * h, n)
    o4, s4 = ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(w),
                            u_h.expand(b, h, n), s0.reshape(b, h, n, n))
    o3, s3 = ops.rwkv6_scan(r, k, v, w, u_bh, s0)
    torch.testing.assert_close(o4.reshape(b * h, s, n), o3, rtol=0, atol=0)
    torch.testing.assert_close(s4.reshape(b * h, n, n), s3, rtol=0, atol=0)


def test_cpu_operands_take_the_plain_version_and_count_no_launch():
    _, t_in = scan_inputs(2, 5, 16)
    before = scan_mod.rwkv6_scan.launches
    got = ops.rwkv6_scan(*t_in)
    want = scan_mod.plain(*t_in)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert scan_mod.rwkv6_scan.launches == before
    with pytest.raises(ValueError):       # the kernel itself takes no CPU
        scan_mod.rwkv6_scan(*t_in)
    meta = [torch.empty(t.shape, device="meta") for t in t_in]
    with pytest.raises(ValueError):       # neither all-CPU nor all-CUDA
        ops.rwkv6_scan(*t_in[:5], meta[5])
    assert scan_mod.rwkv6_scan.launches == before


# ---------------------------------------------------------------------------
# the layers, on converted parameters
# ---------------------------------------------------------------------------

@pytest.fixture(params=["float32", "bfloat16"])
def compute(request, monkeypatch):
    """Both packages' compute type set to one type; yields its tolerance."""
    jdt, tdt, tol = DTYPES[request.param]
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", tdt)
    return tol


def layer_input(seed, b=2, s=10):
    x = np.random.RandomState(seed).randn(b, s, D).astype(np.float32)
    return (jnp.asarray(x).astype(JL.COMPUTE_DTYPE),
            torch.from_numpy(x).to(TL.COMPUTE_DTYPE))


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(compute, with_state):
    jp = JS.rwkv6_init(jax.random.PRNGKey(0), D, HEADS, lora_rank=LORA)
    tp = convert.from_jax_params(jp, device="cpu")
    jx, tx = layer_input(1)
    jstate = tstate = None
    if with_state:
        rng = np.random.RandomState(2)
        xp = rng.randn(2, 1, D).astype(np.float32)
        s0 = (rng.randn(2, HEADS, D // HEADS, D // HEADS) * 0.1).astype(
            np.float32)
        jstate = (jnp.asarray(xp), jnp.asarray(s0))
        tstate = (torch.from_numpy(xp), torch.from_numpy(s0))
    jout, (jxp, js) = jax.jit(
        lambda p, x, st: JS.rwkv6_time_mix(p, x, HEADS, state=st))(
            jp, jx, jstate)
    tout, (txp, ts) = TS.rwkv6_time_mix(tp, tx, HEADS, state=tstate)
    assert tout.dtype == TL.COMPUTE_DTYPE and txp.dtype == ts.dtype == \
        torch.float32
    close(tout, jout, compute, "out")
    close(txp, jxp, compute, "x_prev")
    close(ts, js, compute, "S")


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(compute, with_state):
    jp = JS.rwkv6_channel_mix_init(jax.random.PRNGKey(1), D, FF)
    tp = convert.from_jax_params(jp, device="cpu")
    jx, tx = layer_input(3)
    jstate = tstate = None
    if with_state:
        xp = np.random.RandomState(4).randn(2, 1, D).astype(np.float32)
        jstate, tstate = jnp.asarray(xp), torch.from_numpy(xp)
    jout, jxp = jax.jit(JS.rwkv6_channel_mix)(jp, jx, jstate)
    tout, txp = TS.rwkv6_channel_mix(tp, tx, state=tstate)
    close(tout, jout, compute, "out")
    close(txp, jxp, compute, "x_prev")


def test_inits_have_the_jax_structure():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", (tuple(v.shape), str(v.dtype))

    for t, j in [(TS.rwkv6_init(gen, D, HEADS, LORA, lead=(3,)),
                  JS.rwkv6_init(key, D, HEADS, LORA)),
                 (TS.rwkv6_channel_mix_init(gen, D, FF, lead=(3,)),
                  JS.rwkv6_channel_mix_init(key, D, FF))]:
        assert dict(flat(t)) == {k: ((3,) + s, f"torch.{d}")
                                 for k, (s, d) in flat(j)}
    u = TS.rwkv6_init(gen, 256, 4, lead=(2,))["u"]     # scale 0.5
    assert abs(float(u.std()) - 0.5) < 0.05


# ---------------------------------------------------------------------------
# twins of tests/test_ssm.py::TestRWKV6, on the port alone
# ---------------------------------------------------------------------------

def _randn(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32))


def test_prefill_then_decode_consistency():
    p = TS.rwkv6_init(torch.Generator().manual_seed(0), D, HEADS,
                      lora_rank=LORA)
    x = _randn(1, 2, 12, D)
    y_full, st_full = TS.rwkv6_time_mix(p, x, HEADS)
    st, ys = None, []
    for t in range(12):
        y, st = TS.rwkv6_time_mix(p, x[:, t:t + 1], HEADS, state=st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(st[1], st_full[1], rtol=2e-3, atol=2e-3)


def test_channel_mix_shift_consistency():
    p = TS.rwkv6_channel_mix_init(torch.Generator().manual_seed(1), 16, 32)
    x = _randn(2, 1, 8, 16)
    y_full, _ = TS.rwkv6_channel_mix(p, x)
    st, ys = None, []
    for t in range(8):
        y, st = TS.rwkv6_channel_mix(p, x[:, t:t + 1], state=st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=1e-4,
                               atol=1e-5)


def test_decay_in_unit_interval():
    p = TS.rwkv6_init(torch.Generator().manual_seed(0), D, HEADS,
                      lora_rank=LORA)
    *_, w = TS._rwkv6_projections(p, _randn(3, 1, 6, D),
                                  torch.zeros(1, 1, D), HEADS)
    assert w.dtype == torch.float32
    assert float(w.min()) > 0.0 and float(w.max()) < 1.0
