"""Each roofline count against a hand count at a small shape, and the
model-FLOP counts."""
import json

import pytest
import torch

from portbench import counts, peaks
from portbench.tests.conftest import ROOT


class Rel:
    def __init__(self, m, n):
        self.i = torch.zeros(m * n, dtype=torch.int32)
        self.j = torch.zeros(m * n, dtype=torch.int32)
        self.v = torch.zeros(m * n)
        self.shape = (m, n)

    @property
    def capacity(self):
        return self.i.shape[0]


def least(flops, price, nbytes):
    return max(flops / price, nbytes / peaks.HBM_BYTES_PER_S)


def test_relational_matmul_of_relations():
    left, right, out = Rel(6, 5), Rel(5, 3), Rel(6, 3)
    fwd, bwd = counts.relmm_relation((left, right), {}, out)
    # 30 tuples of 12 bytes, the right relation's 15 values, 18 tuples out
    assert fwd == pytest.approx(least(2 * 30 * 3, peaks.F32_FLOPS,
                                      30 * 12 + 15 * 4 + 18 * 12))
    assert bwd == 0


def test_sigmoid_matmul():
    x, w, out = torch.zeros(7, 5), torch.zeros(5, 3), torch.zeros(7, 3)
    fwd, _ = counts.sigmoid_matmul((x, w), {}, out)
    assert fwd == pytest.approx(least(2 * 7 * 5 * 3, peaks.F32_FLOPS,
                                      (35 + 15 + 21) * 4))


def test_moe_dispatch():
    x = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.zeros(6, dtype=torch.int32)
    gates = torch.zeros(6)
    out = torch.zeros(6, 8, dtype=torch.bfloat16)
    fwd, bwd = counts.moe_dispatch((x, idx, gates), {}, out)
    assert fwd == pytest.approx(least(6 * 8, peaks.F32_FLOPS,
                                      64 + 24 + 24 + 96))
    # d out read, the relation read, d x written
    assert bwd == pytest.approx(least(2 * 6 * 8, peaks.F32_FLOPS,
                                      96 + 48 + 64))


def test_relational_matmul_and_its_backward():
    rows = torch.zeros(10, dtype=torch.int32)
    cols = torch.zeros(10, dtype=torch.int32)
    vals = torch.zeros(10, requires_grad=True)
    b = torch.zeros(7, 4, dtype=torch.bfloat16, requires_grad=True)
    out = torch.zeros(3, 4)
    fwd, bwd = counts.relational_matmul((rows, cols, vals, b, 3), {}, out)
    assert fwd == pytest.approx(least(2 * 10 * 4, peaks.F32_FLOPS,
                                      120 + 56 + 48))
    # d b and d vals: d out and the relation read once, b read, both written
    assert bwd == pytest.approx(least(4 * 10 * 4, peaks.F32_FLOPS,
                                      120 + 48 + 56 + 40))


def test_flash_attention_causal():
    b, h, s, d, dv = 1, 2, 4, 8, 4
    q = torch.zeros(b, h, s, d, dtype=torch.bfloat16)
    k = torch.zeros(b, h, s, d, dtype=torch.bfloat16)
    v = torch.zeros(b, h, s, dv, dtype=torch.bfloat16)
    out = torch.zeros(b, h, s, dv, dtype=torch.bfloat16)
    fwd, bwd = counts.flash_attention((q, k, v), {"causal": True}, out)
    pairs = 2 * (4 * 5 / 2)
    qkv = 2 * (64 + 64 + 32)
    assert fwd == pytest.approx(least(pairs * (2 * d + 2 * dv),
                                      peaks.BF16_FLOPS, qkv + 64))
    assert bwd == pytest.approx(least(pairs * (6 * d + 4 * dv),
                                      peaks.BF16_FLOPS, 2 * qkv + 64))


def test_work_takes_the_larger_bound():
    assert counts.Work(flops_f32=495e12, bytes=1e12).seconds() == \
        pytest.approx(1.0)
    assert counts.Work(flops_bf16=989e12, bytes=6.7e12).seconds() == \
        pytest.approx(2.0)


def test_model_flops():
    c = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-5l.json")
                   .read_text())
    # MLA 13,762,560 a layer; the dense SwiGLU 67,239,936; a MoE layer's
    # 8 experts of 3 x 2048 x 1408 and its router; the head 2048 x 102400
    assert counts.lm_active_params(c) == (5 * 13_762_560 + 67_239_936
                                          + 4 * (69_206_016 + 131_072)
                                          + 209_715_200) == 623_116_288
    attn = 3 * 5 * 16 * 2 * (192 + 128) * 4097 / 2
    assert counts.lm_train_flops_per_token(c, 4096) == pytest.approx(
        6 * 623_116_288 + attn)
    mlp = json.loads((ROOT / "portbench/configs/mlp-mnist-60k.json")
                     .read_text())
    assert counts.mlp_pass_flops(mlp, 60000) == 6 * 60000 * 158800
