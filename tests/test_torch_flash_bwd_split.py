"""The arithmetic of the flash backward kernel on the tensor cores, emulated
on the CPU: the evidence, before the card, that its split products meet the
unchanged tolerances.

``csrc/flash_attention_bwd.cu`` runs all five products on wgmma.  In
bf16, S = q·kᵀ and dP = dO·vᵀ have exact bf16 operands; dV = Pᵀ·dO,
dK = dSᵀ·q and dQ = dS·k each have one float32 operand (P or dS), which
the kernel cuts in its registers into bf16 parts (hi = bf16(x), lo =
bf16(x - hi)), each multiplied by the exact bf16 operand and summed in
float32.  In
float32 every product is 3xTF32: each operand split into TF32 hi and lo
(rounded to nearest by bit masking, as ``cvt.rna`` rounds), a·b taken as
lo·hi + hi·lo + hi·hi in float32.  Here the same products run as float32
CPU matmuls of the parts (a product of two bf16 or two TF32 values is exact
in float32) and the result is held against the float64 plain backward at
the card tests' tolerances and shapes.  Two bf16 parts meet ``BF16_BWD`` as
float32 arithmetic does; one part, FlashAttention's bf16 P and dS, does not.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import HEAD_DIMS

F32_TOL = dict(rtol=2e-4, atol=2e-5)             # tests/test_kernels.py
BF16_BWD = dict(rtol=8.1e-3, atol=2.1e-5)        # tests/test_torch_cuda.py
LOG2E = 1.4426950408889634

_shares: dict[str, float] = {}


@pytest.fixture(scope="module", autouse=True)
def _report_shares():
    yield
    for kind, share in sorted(_shares.items()):
        print(f"\nflash bwd split emulation, {kind}: largest share of the "
              f"tolerance {share:.4f}")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 to nearest, ties away from zero, by adding
    half a unit of the 13 dropped bits to the int32 word and clearing them
    (the kernel's ``to_tf32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _bf16_parts(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x cut into n bf16 parts, each the remainder rounded to nearest even."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16).to(torch.float32))
        rest = rest - parts[-1]
    return parts


def _mm_split(n: int):
    """a·b with a float32 cut into n bf16 parts and b exact in bf16: the
    parts' products summed in one float32 matmul over the stacked parts."""
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        parts = _bf16_parts(a, n)[::-1]            # the small terms first
        return torch.cat(parts, dim=-1) @ torch.cat([b] * n, dim=-2)
    return mm


def _emulate(q, k, v, do, causal, mm_scores, mm_grad):
    """(dq, dk, dv) as the kernel forms them: scores and dP by
    ``mm_scores``, the statistics in float32 in the log2 domain, and the
    three gradient products by ``mm_grad`` with P or dS as their first
    operand; each gradient cast to the operands' type."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = d ** -0.5
    x = mm_scores(qf, kf.transpose(-1, -2)) * torch.tensor(scale * LOG2E)
    if causal:
        x = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), x, -1e30)
    m = x.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(x - m).sum(dim=-1, keepdim=True))
    p = torch.exp2(x - lse)
    dp = mm_scores(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dv = mm_grad(p.transpose(-1, -2), dof)
    dk = mm_grad(ds.transpose(-1, -2), qf) * scale
    dq = mm_grad(ds, kf) * scale
    dk = dk.reshape(b, -1, group, s, d).sum(dim=2)
    dv = dv.reshape(b, -1, group, s, v.shape[-1]).sum(dim=2)
    return [g.to(q.dtype) for g in (dq, dk, dv)]


def _inputs(d, dv, s, group, dtype):
    rng = np.random.RandomState(d + dv + s + group)
    return [torch.tensor(rng.randn(2, h, s, w), dtype=torch.float32).to(dtype)
            for h, w in ((2 * group, d), (2, d), (2, dv), (2 * group, dv))]


def _share(got, want, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1 is the edge."""
    return max(float(((g.double() - w.double()).abs() / (
        tol["atol"] + tol["rtol"] * w.double().abs())).max())
        for g, w in zip(got, want))


def _oracle(q, k, v, do, causal):
    return [g.to(t.dtype) for g, t in zip(ref.flash_attention_bwd(
        *(t.double() for t in (q, k, v, do)), causal=causal), (q, k, v))]


@pytest.mark.parametrize("d,dv", HEAD_DIMS)
@pytest.mark.parametrize("s", [63, 65, 200])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_products_meet_the_tolerance(d, dv, s, group, causal, dtype):
    """bf16: exact scores, P and dS in two bf16 parts, at BF16_BWD; float32:
    every product 3xTF32, at F32_TOL; against the float64 plain backward."""
    q, k, v, do = _inputs(d, dv, s, group, dtype)
    if dtype == torch.bfloat16:
        kind, tol = "bf16, two parts", BF16_BWD
        got = _emulate(q, k, v, do, causal, torch.matmul, _mm_split(2))
    else:
        kind, tol = "float32, 3xTF32", F32_TOL
        got = _emulate(q, k, v, do, causal, _mm_3xtf32, _mm_3xtf32)
    want = _oracle(q, k, v, do, causal)
    share = _share(got, want, tol)
    _shares[kind] = max(_shares.get(kind, 0.0), share)
    print(f"{kind} (D, Dv) = ({d}, {dv}), S {s}, group {group}, "
          f"causal {causal}: {share:.4f} of the tolerance")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.double(), w.double(), **tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("d,dv", [(128, 128), (192, 128)])
def test_one_bf16_part_misses_the_tolerance(d, dv):
    """P and dS rounded once to bf16 before dV, dK and dQ (the usual choice)
    add about 2^-9 of every term: far beyond one bf16 ulp of the result."""
    q, k, v, do = _inputs(d, dv, 200, 4, torch.bfloat16)
    got = _emulate(q, k, v, do, True, torch.matmul, _mm_split(1))
    share = _share(got, _oracle(q, k, v, do, True), BF16_BWD)
    print(f"bf16, one part, ({d}, {dv}): {share:.4f} of the tolerance")
    assert share > 2.0
