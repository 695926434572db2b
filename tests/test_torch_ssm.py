"""Twins of the JAX package's RWKV-6 and Mamba-2 layers and of its
``rwkv6_scan`` kernel tests, for the port: the same numpy inputs through
``repro.nn.ssm`` / ``repro.kernels`` and ``repro_torch.nn.ssm`` /
``repro_torch.kernels`` on the CPU.

The port's RWKV-6 recurrence is ``ops.rwkv6_scan``; on the CPU it is the
plain version, held here against the JAX oracle ``ref.rwkv6_scan`` and the
Pallas kernel in interpret mode at ``tests/test_kernels.py``'s shapes and
tolerance (``rtol=atol=3e-4``), and at ragged S.  The layers are held
against JAX's on converted parameters in float32 compute (``rtol=2e-4,
atol=2e-5``) and in bf16 compute (the model tests' ``rtol=0.08,
atol=0.05``), with and without an incoming state; the RWKV-6 tests at the
end of its part are the port's twins of ``tests/test_ssm.py::TestRWKV6``.

Mamba-2's SSD (no kernel in either package): ``ssd_chunked``,
``ssd_scan`` and ``ssd_naive`` against their JAX functions at
``tests/test_ssm.py``'s three shapes, with and without an entering state,
at the float32 tolerance; the ``s == 1`` decode branch; bf16 chunk math at
the bf16 one; the mixer under both ``ssd_impl``s; then the port's own
twins of ``tests/test_ssm.py::TestSSD`` and ``TestMamba2Mixer`` at that
file's tolerances (2e-4 between the SSD forms, 2e-3 between the mixer's
prefill and its step-by-step decode).
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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD): the port against the JAX functions
# ---------------------------------------------------------------------------

F32 = DTYPES["float32"][2]
BF16 = DTYPES["bfloat16"][2]
SSD_SHAPES = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32),
              (2, 96, 3, 8, 8, 32)]                  # tests/test_ssm.py
SSD_FORMS = ["chunked", "scan", "naive"]


def ssd_inputs(b, s, h, p, n, seed=1, with_h0=False):
    """test_ssm.py's inputs: x, B, C standard normal, a = -|randn| / 10,
    and an entering state h0 (B,H,N,P) where asked."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, h, p), -np.abs(rng.randn(b, s, h)) * 0.1,
              rng.randn(b, s, n), rng.randn(b, s, n)]
    arrays.append(rng.randn(b, h, n, p) if with_h0 else None)
    arrays = [None if a is None else a.astype(np.float32) for a in arrays]
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(a) for a in arrays])


def run_ssd(form, mod, args, chunk, **kw):
    x, a, b_in, c_in, h0 = args
    if form == "naive":
        return mod.ssd_naive(x, a, b_in, c_in, h0=h0)
    fn = mod.ssd_chunked if form == "chunked" else mod.ssd_scan
    return fn(x, a, b_in, c_in, chunk=chunk, h0=h0, **kw)


@pytest.mark.parametrize("form", SSD_FORMS)
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_matches_jax(form, shape, with_h0):
    *dims, chunk = shape
    j_in, t_in = ssd_inputs(*dims, with_h0=with_h0)
    # the naive loop runs eagerly: under jit its unrolled steps take
    # seconds to compile
    jfn = lambda *a: run_ssd(form, JS, a, chunk)
    jy, jh = (jfn if form == "naive" else jax.jit(jfn))(*j_in)
    ty, th = run_ssd(form, TS, t_in, chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == t_in[0].shape and th.shape == (dims[0], dims[2],
                                                      dims[4], dims[3])
    close(ty, jy, F32, f"{form} y")
    close(th, jh, F32, f"{form} h_fin")


@pytest.mark.parametrize("form", ["chunked", "scan"])
def test_ssd_decode_branch_matches_jax(form):
    """S = 1 takes the plain recurrence in both packages (ssd_scan hands it
    to ssd_chunked), from an entering state."""
    j_in, t_in = ssd_inputs(3, 1, 4, 8, 16, seed=5, with_h0=True)
    jy, jh = jax.jit(lambda *a: run_ssd(form, JS, a, 64))(*j_in)
    ty, th = run_ssd(form, TS, t_in, 64)
    assert ty.shape == (3, 1, 4, 8)
    close(ty, jy, F32, "y")
    close(th, jh, F32, "h")


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_in_bf16_matches_jax(shape):
    """compute_dtype=bf16: x, B, C, L and the decays rounded to bf16 where
    the JAX function rounds them, each product summed in float32; bf16
    inputs give a bf16 y and a float32 state."""
    *dims, chunk = shape
    j_in, t_in = ssd_inputs(*dims, seed=2, with_h0=True)
    j_in[0], t_in[0] = j_in[0].astype(jnp.bfloat16), t_in[0].to(
        torch.bfloat16)
    jy, jh = jax.jit(lambda *a: JS.ssd_chunked(
        *a[:4], chunk=chunk, h0=a[4], compute_dtype=jnp.bfloat16))(*j_in)
    ty, th = TS.ssd_chunked(*t_in[:4], chunk=chunk, h0=t_in[4],
                            compute_dtype=torch.bfloat16)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    close(ty, jy, BF16, "y")
    close(th, jh, BF16, "h_fin")


def test_ssd_refuses_a_ragged_sequence():
    """The reference's assert, kept: S a multiple of the chunk, or 1."""
    _, t_in = ssd_inputs(1, 20, 2, 4, 4)
    with pytest.raises(AssertionError):
        TS.ssd_chunked(*t_in[:4], chunk=16)
    y, _ = TS.ssd_scan(*t_in[:4], chunk=20)            # min(chunk, s) = s
    assert y.shape == (1, 20, 2, 4)


MIXER = dict(d=32, heads=4, d_state=8)


def mixer_dims(d, heads, d_state):
    return (2 * d, (2 * d) // heads, d_state, 4)


@pytest.mark.parametrize("ssd_impl", ["parallel", "scan"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mixer_matches_jax(compute, ssd_impl, with_state):
    d, heads, n = MIXER["d"], MIXER["heads"], MIXER["d_state"]
    dims = mixer_dims(d, heads, n)
    jp = JS.mamba2_init(jax.random.PRNGKey(3), d, heads, n)
    # a_log, dt_bias and d_skip away from their constant inits, so that
    # they are read
    rng = np.random.RandomState(4)
    jp = dict(jp, a_log=jnp.asarray(rng.randn(heads).astype(np.float32)),
              dt_bias=jnp.asarray(rng.randn(heads).astype(np.float32)),
              d_skip=jnp.asarray(rng.randn(heads).astype(np.float32)))
    tp = convert.from_jax_params(jp, device="cpu")
    x = rng.randn(2, 16, d).astype(np.float32)
    jx = jnp.asarray(x).astype(JL.COMPUTE_DTYPE)
    tx = torch.from_numpy(x).to(TL.COMPUTE_DTYPE)
    jstate = tstate = None
    if with_state:
        conv = rng.randn(2, 3, 2 * d + 2 * n).astype(np.float32)
        h0 = (rng.randn(2, heads, n, 2 * d // heads) * 0.1).astype(
            np.float32)
        jstate = (jnp.asarray(conv), jnp.asarray(h0))
        tstate = (torch.from_numpy(conv), torch.from_numpy(h0))
    jout, (jconv, jh) = jax.jit(lambda p, x, st: JS.mamba2_mixer(
        p, x, dims, state=st, chunk=8, ssd_impl=ssd_impl))(jp, jx, jstate)
    tout, (tconv, th) = TS.mamba2_mixer(tp, tx, dims, state=tstate, chunk=8,
                                        ssd_impl=ssd_impl)
    assert tout.dtype == TL.COMPUTE_DTYPE
    assert tconv.dtype == th.dtype == torch.float32
    assert tconv.shape == (2, 3, 2 * d + 2 * n)
    close(tout, jout, compute, "out")
    close(tconv, jconv, compute, "conv state")
    close(th, jh, compute, "h")


def test_mamba2_init_has_the_jax_structure():
    d, heads, n = MIXER["d"], MIXER["heads"], MIXER["d_state"]
    t = TS.mamba2_init(torch.Generator().manual_seed(0), d, heads, n,
                       lead=(3,))
    j = JS.mamba2_init(jax.random.PRNGKey(0), d, heads, n)

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield f"{pre}{k}", (tuple(v.shape), str(v.dtype))

    assert dict(flat(t)) == {k: ((3,) + s, f"torch.{d}")
                             for k, (s, d) in flat(j)}
    assert torch.equal(t["a_log"], torch.zeros(3, heads))
    assert torch.equal(t["d_skip"], torch.ones(3, heads))
    conv = TS.mamba2_init(torch.Generator().manual_seed(1), 256, 8, 64,
                          lead=(2,))["conv_w"]              # scale 0.5
    assert abs(float(conv.std()) - 0.5) < 0.05


# ---------------------------------------------------------------------------
# twins of tests/test_ssm.py::TestSSD and TestMamba2Mixer, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_forms_agree(shape):
    *dims, chunk = shape
    _, t_in = ssd_inputs(*dims, seed=6, with_h0=True)
    yn, hn = run_ssd("naive", TS, t_in, chunk)
    for form in ("chunked", "scan"):
        y, h = run_ssd(form, TS, t_in, chunk)
        torch.testing.assert_close(y, yn, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, hn, rtol=2e-4, atol=2e-4)


def test_ssd_decode_steps_match_full_sequence():
    """Running S single-token steps == one full-sequence pass."""
    _, (x, a, b_in, c_in, _) = ssd_inputs(1, 16, 2, 8, 8, seed=7)
    y_full, _ = TS.ssd_naive(x, a, b_in, c_in)
    hst, ys = None, []
    for t in range(16):
        y, hst = TS.ssd_chunked(x[:, t:t + 1], a[:, t:t + 1],
                                b_in[:, t:t + 1], c_in[:, t:t + 1], h0=hst)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("ssd_impl", ["parallel", "scan"])
def test_mamba2_prefill_then_decode_consistency(ssd_impl):
    d, heads, n = MIXER["d"], MIXER["heads"], MIXER["d_state"]
    dims = mixer_dims(d, heads, n)
    p = TS.mamba2_init(torch.Generator().manual_seed(0), d, heads, n)
    x = _randn(1, 1, 24, d)
    y_full, st_full = TS.mamba2_mixer(p, x, dims, chunk=8,
                                      ssd_impl=ssd_impl)
    st, ys = None, []
    for t in range(24):
        y, st = TS.mamba2_mixer(p, x[:, t:t + 1], dims, state=st,
                                ssd_impl=ssd_impl)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(st[1], st_full[1], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st[0], st_full[0], rtol=2e-3, atol=2e-3)
