"""The port's roofline (``repro_torch.roofline.analysis``) against the JAX
package's: the wire factors and kinds of ``tests/test_roofline.py``
(there parsed from HLO text, here built from the collectives a DTensor
step issues), ``model_flops`` for every arch × shape, the depth
extrapolation, the bottleneck, and the per-device count of a sharded
product, which ``FlopCounterMode`` over DTensors reads at its global
size."""
from __future__ import annotations

import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.roofline import analysis as A

HLO_SAMPLE = """
HloModule test
%add { ... }
ENTRY %main {
  %ar = f32[1024,512]{1,0} all-reduce(%x), channel_id=1, replica_groups=[32,16]<=[512], use_global_device_ids=true, to_apply=%add
  %ag = bf16[256,256]{1,0} all-gather(%y), channel_id=2, replica_groups=[16,32]<=[512], dimensions={0}
  %rs = f32[64,64]{1,0} reduce-scatter(%z), channel_id=3, replica_groups=[2,256]<=[512], to_apply=%add
  %cp = f32[128]{0} collective-permute(%w), channel_id=4, source_target_pairs={{0,1}}
  %nothing = f32[8,8]{1,0} add(%a, %b)
}
"""
# the same collectives as (kind, result bytes, group size) records
RECORDS = [("all-reduce", 1024 * 512 * 4, 16),
           ("all-gather", 256 * 256 * 2, 32),
           ("reduce-scatter", 64 * 64 * 4, 256),
           ("collective-permute", 128 * 4, 1)]


class TestCollectives:
    def test_kinds_and_counts(self):
        st = A.collective_stats(RECORDS)
        assert set(st.by_kind) == {"all-reduce", "all-gather",
                                   "reduce-scatter", "collective-permute"}
        assert all(v["count"] == 1 for v in st.by_kind.values())

    def test_wire_byte_factors(self):
        st = A.collective_stats(RECORDS)
        ar = 1024 * 512 * 4
        assert st.by_kind["all-reduce"]["wire"] == pytest.approx(
            2 * 15 / 16 * ar)
        ag = 256 * 256 * 2
        assert st.by_kind["all-gather"]["wire"] == pytest.approx(
            31 / 32 * ag)
        rs = 64 * 64 * 4
        assert st.by_kind["reduce-scatter"]["wire"] == pytest.approx(
            255 * rs)
        assert st.by_kind["collective-permute"]["wire"] == 128 * 4

    def test_equal_to_jax_parse_of_the_same_collectives(self):
        st, jst = A.collective_stats(RECORDS), janalysis.parse_collectives(
            HLO_SAMPLE)
        assert st.by_kind == jst.by_kind
        assert st.wire_bytes == pytest.approx(jst.wire_bytes)
        assert st.total_result_bytes() == jst.total_result_bytes()

    def test_no_collectives(self):
        st = A.collective_stats([])
        assert st.wire_bytes == 0 and st.by_kind == {}

    @pytest.mark.parametrize("g", [1, 2, 16, 512])
    def test_all_to_all_factor(self, g):
        assert A.wire_bytes("all-to-all", 1000.0, g) == pytest.approx(
            (g - 1) / g * 1000.0)


class TestCounter:
    def test_depth_extrapolation_is_exact_for_identical_layers(self):
        """cost(L) is affine in L when layers are identical: c1 + (L-1)·Δ,
        for the FLOPs and for the bytes."""

        def cost(n):
            x = torch.empty(32, 64, device="meta")
            w = torch.empty(64, 64, device="meta")
            with A.CostCounter() as c:
                for _ in range(n):
                    x = torch.tanh(x @ w)
                x.sum()
            return c.flops, c.bytes

        (f1, b1), (f2, b2), (f5, b5) = cost(1), cost(2), cost(5)
        assert f1 == 2 * 32 * 64 * 64
        assert f5 == pytest.approx(f1 + 4 * (f2 - f1))
        assert b5 == pytest.approx(b1 + 4 * (b2 - b1))

    def test_bytes_are_operands_and_outputs_views_free(self):
        x = torch.empty(8, 16, device="meta")
        with A.CostCounter() as c:
            y = x.t()                       # a view: moves nothing
            z = y + 1.0                     # reads 512 B, writes 512 B
        assert c.bytes == 2 * 8 * 16 * 4 and c.flops == 0
        assert c.peak == 8 * 16 * 4
        del z

    def test_peak_counts_freed_outputs_out(self):
        x = torch.empty(1024, device="meta")
        with A.CostCounter() as c:
            for _ in range(4):
                y = x * 2.0                 # each drops the one before
            del y
        assert c.peak == 2 * 1024 * 4 and c.live == 0

    def test_kernel_entry_points_count_themselves(self):
        from repro_torch.kernels import ops
        q = torch.empty(2, 4, 64, 32, device="meta")
        k = torch.empty(2, 2, 64, 32, device="meta")
        with A.CostCounter() as c:
            out = ops.flash_attention(q, k, k)
        pairs = 2 * 4 * 64 * 65 // 2
        assert out.shape == (2, 4, 64, 32) and out.device.type == "meta"
        assert c.flops == 2 * pairs * (32 + 32)
        assert c.bytes == 4 * (q.numel() + 2 * k.numel() + out.numel())


def test_sharded_product_is_counted_per_device():
    """(128 × 4096)·(4096 × 11008) with its operands sharded over a
    (2, 16, 16) mesh of 512 placeholder ranks: ``FlopCounterMode`` reads
    the global product, the counter the local one, 1/512 of it."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import placeholder_group
    from repro_torch.launch.mesh import make_production_mesh

    placeholder_group(512)
    try:
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        x = distribute_tensor(torch.empty(128, 4096, device="meta"), mesh,
                              [Shard(0), Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(4096, 11008, device="meta"), mesh,
                              [Replicate(), Shard(0), Shard(1)])
        x @ w                                   # sharding propagation warm
        with FlopCounterMode(display=False) as fc:
            x @ w
        with A.CostCounter() as c:
            x @ w
        glob = 2 * 128 * 4096 * 11008
        assert fc.get_total_flops() == glob
        assert c.flops == glob / 512
        assert c.collectives and c.stats().wire_bytes > 0
    finally:
        dist.destroy_process_group()


class TestModelFlops:
    @pytest.mark.parametrize("n_chips", [256, 512])
    @pytest.mark.parametrize("shape", list(SHAPES))
    @pytest.mark.parametrize("aid", ARCH_IDS)
    def test_equal_to_jax(self, aid, shape, n_chips):
        assert A.model_flops(get_config(aid), SHAPES[shape], n_chips) == \
            pytest.approx(janalysis.model_flops(jget_config(aid),
                                                JSHAPES[shape], n_chips))

    def test_dense_6nd(self):
        cfg = get_config("yi_6b")
        mf = A.model_flops(cfg, SHAPES["train_4k"], 256)
        assert mf == pytest.approx(6 * cfg.n_params * 4096 * 256 / 256)

    def test_moe_uses_active_params(self):
        cfg = get_config("dbrx_132b")
        assert cfg.n_active_params() < 0.35 * cfg.n_params
        mf = A.model_flops(cfg, SHAPES["train_4k"], 256)
        assert mf == pytest.approx(6 * cfg.n_active_params() * 4096 * 256
                                   / 256)

    def test_roofline_bottleneck(self):
        r = A.roofline(1e15, 1e12, 1e9, 5e14)
        assert r.bottleneck == "compute"
        assert r.step_s == pytest.approx(1e15 / A.PEAK_FLOPS)
        assert 0.4 < r.useful_ratio <= 0.5
        assert r.roofline_fraction == pytest.approx(0.5)
        m = A.roofline(1e12, 1e13, 1e9)
        assert m.bottleneck == "memory" and m.step_s == pytest.approx(
            1e13 / A.HBM_BW)
        x = A.roofline(1e12, 1e9, 1e12)
        assert x.bottleneck == "collective"


def test_hopper_constants():
    """H100 SXM: bf16 989 TFLOP/s dense (TF32 495, float32 67), HBM3
    3.35 TB/s, one 400 Gb/s NDR port a GPU between nodes."""
    assert (A.PEAK_FLOPS, A.PEAK_FLOPS_TF32, A.PEAK_FLOPS_F32) == \
        (989e12, 495e12, 67e12)
    assert A.HBM_BW == 3.35e12 and A.LINK_BW == 400e9 / 8
