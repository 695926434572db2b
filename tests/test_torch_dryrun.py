"""The port's dry-run (``repro_torch.launch.dryrun``) on placeholder ranks:
reduced configs of every family through ``lower_cell`` on the 512-rank
(2, 16, 16) mesh (prefill and decode here, training in
``test_torch_dryrun_train.py``, so that the two run side by side) and the
256-rank (16, 16) one, a fake process group in this process, meta tensors
only.  Each cell must run through ("ok"), with
JAX's record keys, every planned output placed as planned, and its
argument bytes equal to the local shards the plan gives rank 0 (computed
here from the specs).  ``apply_overrides`` and ``ssm_scan_corrections``
equal the JAX package's."""
from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, sharding as sh
from repro_torch.launch.mesh import abstract_mesh, axis_size
from repro_torch.launch.specs import (batch_specs, cache_specs, on_meta,
                                      params_specs)
from repro_torch.optim.optimizers import adamw

MESHES = {True: ((2, 16, 16), ("pod", "data", "model")),
          False: ((16, 16), ("data", "model"))}
# the production kinds at a size a test can run: batch 64 divides both
# meshes' data axes, the sequences divide the reduced SSD chunk (16), and
# training's 65,536 tokens make 32 MoE groups of 2048, as many as data
# ranks (the backward reshapes the groups as they are sharded)
SMALL = {"train": ShapeSpec("train_4k", 1024, 64, "train"),
         "prefill": ShapeSpec("prefill_32k", 64, 64, "prefill"),
         "decode": ShapeSpec("decode_32k", 64, 64, "decode")}
RECORD_KEYS = {"arch", "shape", "mesh", "status", "compile_s", "overrides",
               "bytes_per_device", "flops_per_device", "hbm_bytes_per_device",
               "wire_bytes_per_device", "collectives", "terms_s",
               "bottleneck", "model_flops_per_device", "useful_flop_ratio",
               "roofline_fraction"}


@pytest.fixture(scope="module", autouse=True)
def placeholder_ranks():
    """The fake group lives for this module only: other test files set up
    groups of their own in the same process."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def local_bytes(tree, specs, mesh) -> int:
    """Rank 0's bytes of ``tree`` placed by ``specs``: a dim split k ways
    keeps its first chunk, ceil(n / k) (torch.chunk's)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v, s, mesh) for v, s in zip(tree, specs))
    shape = list(tree.shape)
    for d, e in enumerate(specs):
        if e is not None:
            k = axis_size(mesh, e)
            shape[d] = -(-shape[d] // k)
    n = 1
    for s in shape:
        n *= s
    return n * tree.element_size()


def plan_bytes(cfg, shape, multi) -> int:
    m = abstract_mesh(*MESHES[multi])
    p = params_specs(cfg)
    total = local_bytes(p, sh.param_shardings(p, m), m)
    b = batch_specs(cfg, shape)
    total += local_bytes(b, sh.batch_shardings(b, m, shape.global_batch), m)
    if shape.kind == "train":
        with on_meta():
            o = adamw(3e-4, mixed_precision=cfg.param_dtype != "float32"
                      ).init(p)
        total += local_bytes(o, sh.opt_shardings(o, None, m), m)
    if shape.kind == "decode":
        c = cache_specs(cfg, shape)
        total += local_bytes(c, sh.cache_shardings(
            c, m, shape.global_batch, shape.seq_len, cfg), m)
    return total


FAMILIES = ("yi_6b", "deepseek_v2_lite_16b", "dbrx_132b", "rwkv6_7b",
            "zamba2_2_7b", "musicgen_medium", "internvl2_1b")


def run_cell(aid, kind, multi):
    cfg, shape = get_config(aid, reduced=True), SMALL[kind]
    rec, out = dryrun.lower_cell(aid, shape.name, multi_pod=multi, cfg=cfg,
                                 shape=shape)
    assert rec["status"] == "ok" and set(rec) == RECORD_KEYS
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    by = rec["bytes_per_device"]
    assert by["arguments"] == plan_bytes(cfg, shape, multi)
    assert by["temp"] > 0 and rec["flops_per_device"] > 0
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["model_flops_per_device"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("aid", FAMILIES)
def test_reduced_cell_runs_on_512_placeholder_ranks(aid, kind):
    run_cell(aid, kind, True)


@pytest.mark.parametrize("aid", ["yi_6b", "zamba2_2_7b", "internvl2_1b"])
def test_reduced_prefill_runs_on_256_placeholder_ranks(aid):
    run_cell(aid, "prefill", False)


def test_moe_shard_impl_runs_on_placeholder_ranks():
    """``--set moe.impl=shard``: the expert-owner plan through local_map,
    one all_reduce over 'model' a MoE layer."""
    cfg = get_config("deepseek_v2_lite_16b", reduced=True)
    rec, _ = dryrun.lower_cell("deepseek_v2_lite_16b", "prefill_32k",
                               multi_pod=False, cfg=cfg,
                               shape=SMALL["prefill"],
                               overrides={"moe.impl": "shard"})
    assert rec["status"] == "ok"
    assert rec["collectives"]["all-reduce"]["count"] >= 1


def test_a_misplaced_output_fails_the_cell():
    from torch.distributed.tensor import Replicate, distribute_tensor

    dryrun.placeholder_group(256)
    mesh = dryrun.make_production_mesh(device_type="cpu")
    t = distribute_tensor(torch.empty(64, 8, device="meta"), mesh,
                          [Replicate(), Replicate()])
    dryrun._check_placed({"w": t}, {"w": (None, None)}, mesh, "out")
    with pytest.raises(AssertionError, match="the plan names"):
        dryrun._check_placed({"w": t}, {"w": ("data", None)}, mesh, "out")


def test_long_context_skips_as_jax_does():
    rec, out = dryrun.lower_cell("yi_6b", "long_500k", multi_pod=False)
    assert rec["status"] == "skip (full attention)" and out is None


# ---------------------------------------------------------------------------
# against the JAX package's helpers

@pytest.fixture(scope="module")
def jdryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS to 512 host devices when
    imported; the setting is put back at once, so no later test here sees
    it (JAX reads it when its backend first starts)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


OVERRIDES = [{}, {"attn_impl": "chunked"}, {"remat": "dots"},
             {"moe.impl": "shard", "moe.capacity_factor": 2.0},
             {"ssm.chunk": 128}, {"attn_impl": "chunked", "ssm.chunk": 32}]


def _as_jax(port, jax_cfg):
    """``dataclasses.asdict`` of a port config, nested configs too, over
    the JAX package's fields alone; each field the port adds (the
    published Zamba2's) must hold its default, so that the two configs
    describe one model."""
    out = {}
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if not hasattr(jax_cfg, f.name):
            assert value == f.default, f.name
            continue
        theirs = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(value) and theirs is not None:
            value = _as_jax(value, theirs)
        elif dataclasses.is_dataclass(value):
            value = dataclasses.asdict(value)
        out[f.name] = value
    return out


@pytest.mark.parametrize("overrides", OVERRIDES, ids=str)
@pytest.mark.parametrize("aid", ["yi_6b", "deepseek_v2_lite_16b",
                                 "zamba2_2_7b", "rwkv6_7b"])
def test_apply_overrides_equals_jax(jdryrun, aid, overrides):
    from repro.configs.base import get_config as jget_config
    got = dryrun.apply_overrides(get_config(aid), overrides)
    want = jdryrun.apply_overrides(jget_config(aid), overrides)
    assert _as_jax(got, want) == dataclasses.asdict(want)


@pytest.mark.parametrize("n_chips", [256, 512])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_ssm_scan_corrections_equal_jax(jdryrun, aid, shape, n_chips):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget_config
    assert dryrun.ssm_scan_corrections(get_config(aid), SHAPES[shape],
                                       n_chips) == pytest.approx(
        jdryrun.ssm_scan_corrections(jget_config(aid), JSHAPES[shape],
                                     n_chips))
