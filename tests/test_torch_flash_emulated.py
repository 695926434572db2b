"""The float32 flash kernel's arithmetic emulated on the CPU
(``ref.flash_attention_emulated``, ``ref.tf32_parts``), the instrument that
found what set the kernel's distance from float64 at depth:

* the TF32 splits keep their stated bounds on random float32 inputs: one
  part 2^-11 |x|, the kernel's two (hi, lo) 2^-22 |x|, three (hi, mid, lo)
  2^-33 |x|, which for a float32 x (24 significant bits) is exact;
* the tensor cores' truncated accumulation, carried through every key
  tile (the design before the repair), shrinks the output toward zero;
  each tile's P·V summed from zero (the kernel's design) takes most of
  that bias away, and rounding to nearest takes all of it;
* every variant stays within the float32 tolerance of a float64 oracle,
  and the kernel's design within it at the sequence lengths the models
  prefill.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

F32 = dict(rtol=2e-4, atol=2e-5)                # tests/test_kernels.py


def rnd(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("parts,bound", [(1, 2.0 ** -11), (2, 2.0 ** -22),
                                         (3, 2.0 ** -33)])
def test_tf32_parts_meet_their_bound(parts, bound):
    """Each part a TF32 word (the 13 low bits clear); the rest within the
    bound, and within a factor of 4 of it for one and two parts (2^-22 is
    the kernel's split's real error, not a loose one); three parts hold
    every float32 exactly."""
    rng = np.random.RandomState(parts)
    x = torch.from_numpy((rng.randn(200000) * 10.0 ** rng.randint(
        -20, 20, 200000)).astype(np.float32))
    got = ref.tf32_parts(x, parts)
    assert len(got) == parts
    for part in got:
        assert not (part.view(torch.int32) & 0x1FFF).any()
    x64 = x.double()
    rest = (x64 - sum(p.double() for p in got)).abs()
    assert (rest <= bound * x64.abs()).all()
    if parts < 3:
        assert float((rest / x64.abs()).max()) >= bound / 4
    else:
        assert not rest.any()


def test_unsplit_parts_are_the_value():
    x = rnd(np.random.RandomState(0), 64)
    (only,) = ref.tf32_parts(x, 0)
    assert torch.equal(only, x)


def test_round_toward_zero_never_grows_and_stays_within_an_ulp():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(100000) * 10.0 ** rng.randint(-5, 5,
                                                                 100000))
    zero, near = ref.round_f32(x, "zero"), ref.round_f32(x, "nearest")
    assert (zero.double().abs() <= x.abs()).all()
    ulp = torch.nextafter(near.abs(), torch.full_like(near, np.inf)) - \
        near.abs()
    assert ((zero - near).abs() <= ulp).all()
    assert (zero != near).any() and torch.equal(near, x.float())
    with pytest.raises(ValueError):
        ref.round_f32(x, "up")


def signed_error(got, exact) -> float:
    """The mean error along the sign of the exact value, relative to its
    mean magnitude: a shrink toward zero reads negative."""
    err = got.double() - exact
    return float((err * exact.sign()).mean() / exact.abs().mean())


@pytest.fixture(scope="module")
def long_rows():
    rng = np.random.RandomState(7)
    q, k, v = (rnd(rng, 1, 1, 1024, 32) for _ in range(3))
    return q, k, v, ref.flash_attention(q.double(), k.double(), v.double())


def test_carried_accumulator_shrinks_the_output(long_rows):
    q, k, v, exact = long_rows
    carried = ref.flash_attention_emulated(q, k, v, pv_tile=False)
    tiled = ref.flash_attention_emulated(q, k, v)
    nearest = ref.flash_attention_emulated(q, k, v, s_round="nearest",
                                           pv_round="nearest")
    s_carried, s_tiled, s_near = (signed_error(o, exact)
                                  for o in (carried, tiled, nearest))
    assert s_carried < -1e-6                      # a shrink, 1024 keys
    assert abs(s_tiled) < abs(s_carried) / 3
    assert abs(s_near) < abs(s_carried) / 20
    # the split is not what shrinks it: three parts (six products, more
    # truncated sums) shrink it more
    three = ref.flash_attention_emulated(q, k, v, pv_tile=False, parts=3)
    assert signed_error(three, exact) < s_carried


@pytest.mark.parametrize("kw", [dict(), dict(pv_tile=False),
                                dict(parts=3), dict(parts=0),
                                dict(softmax_dtype=torch.float64),
                                dict(s_apart=True, pv_apart=True),
                                dict(s_round="nearest", pv_round="nearest")],
                         ids=["kernel", "carried", "three_parts", "unsplit",
                              "softmax64", "apart", "nearest"])
@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal", [
    (1, 4, 2, 130, 64, 64, True), (1, 2, 2, 77, 32, 32, False),
    (1, 2, 1, 96, 80, 80, True), (1, 2, 2, 64, 192, 128, True)])
def test_every_variant_meets_float32(kw, b, hq, hkv, s, d, dv, causal):
    rng = np.random.RandomState(s + d)
    q, k = rnd(rng, b, hq, s, d), rnd(rng, b, hkv, s, d)
    v = rnd(rng, b, hkv, s, dv)
    got = ref.flash_attention_emulated(q, k, v, causal, **kw)
    exact = ref.flash_attention(q.double(), k.double(), v.double(), causal)
    torch.testing.assert_close(got.double(), exact, **F32)


def test_pv_apart_needs_pv_tile():
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="pv_tile"):
        ref.flash_attention_emulated(x, x, x, pv_tile=False, pv_apart=True)
