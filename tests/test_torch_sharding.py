"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's, on abstract meshes (no process group, no device):

* every case of ``tests/test_sharding.py``, on the port's trees;
* every leaf of all ten configs' param trees (its shape and dtype too,
  from ``LM.init`` on the meta device): the port's spec equals
  ``repro.launch.sharding.param_spec`` of the same leaf on the (16, 16)
  and (2, 16, 16) meshes, with and without FSDP, and so do the ZeRO specs
  of the AdamW state;
* the batch and cache specs of every ``SHAPES`` entry for every config;
* the spec → DTensor placements conversion on the multi-axis entries,
  which DTensor shards in mesh order.
"""
from __future__ import annotations

import functools

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.launch.specs import batch_specs as jbatch_specs
from repro.launch.specs import cache_specs as jcache_specs
from repro.launch.specs import params_specs as jparams_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import abstract_mesh, axis_size, data_axes
from repro_torch.launch.specs import batch_specs, cache_specs, params_specs
from repro_torch.optim.optimizers import adamw
from repro_torch.launch.specs import on_meta

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def mesh(multi=False):
    return abstract_mesh(*MESHES["2x16x16" if multi else "16x16"])


def jmesh(name):
    return jabstract_mesh(*MESHES[name])


def spec(names, shape, m=None, stacked=False, fsdp=True):
    return sh.param_spec(tuple(names), shape, m or mesh(), fsdp=fsdp,
                         stacked=stacked)


def norm(entry):
    """A one-axis tuple is its axis (JAX's P may keep either)."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def jspec(p) -> tuple:
    return tuple(norm(e) for e in tuple(p))


def by_path(tree, path=()):
    """{path of names: leaf} of a port tree of specs or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(by_path(v, path + (str(k),)))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                  not all(e is None or isinstance(e, (str,
                                                                      tuple))
                                          for e in tree)):
        out = {}
        for i, v in enumerate(tree):
            out.update(by_path(v, path + (str(i),)))
        return out
    return {path: tree}


def tensor_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tensor_paths(v, path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(tensor_paths(v, path + (str(i),)))
        return out
    return {path: tree}


def spec_paths(spec_tree, like):
    """The specs of ``spec_tree`` at the tensor paths of ``like``."""
    out = {}
    for path in tensor_paths(like):
        node = spec_tree
        for k in path:
            node = node[k] if isinstance(node, dict) else node[int(k)]
        out[path] = node
    return out


def dtype_name(dtype) -> str:
    """"float32", "bfloat16", "int32" for a torch or a numpy/JAX dtype."""
    return str(dtype).removeprefix("torch.")


def jax_paths(tree, raw=False):
    """{path of names: leaf} of a JAX tree (``raw``: the leaf with JAX's
    own path, as its rules take it)."""
    return {tuple(jsh._path_names(p)): (p, leaf) if raw else leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# tests/test_sharding.py, case by case

class TestParamRules:
    def test_column_parallel_qkv(self):
        s = spec(("layers", "attn", "wq"), (32, 4096, 4096), stacked=True)
        assert s[2] == "model" and s[0] is None       # L axis untouched
        assert s[1] == "data"                         # FSDP dim

    def test_row_parallel_out(self):
        s = spec(("layers", "attn", "wo"), (32, 4096, 4096), stacked=True)
        assert s[1] == "model"

    def test_expert_parallel(self):
        s = spec(("layers", "moe", "wi"), (40, 16, 6144, 10752),
                 stacked=True)
        assert s[1] == "model"                        # experts over model

    def test_vocab_parallel_embed(self):
        s = spec(("embed",), (64000, 4096))
        assert s[0] == "model"

    def test_non_divisible_vocab_not_sharded(self):
        s = spec(("embed",), (49155, 4096))           # granite vocab
        assert s[0] is None and s[1] == "data"        # FSDP still applies

    def test_small_params_replicated(self):
        assert spec(("layers", "norm1", "w"), (32, 4096),
                    stacked=True) == (None, None)
        assert spec(("layers", "attn", "q_norm", "w"), (32, 128),
                    stacked=True) == (None, None)

    @pytest.mark.parametrize("aid", ["yi_6b", "deepseek_v2_lite_16b",
                                     "dbrx_132b", "rwkv6_7b",
                                     "zamba2_2_7b"])
    def test_full_tree_shardings_cover_all_archs(self, aid):
        shapes = params_specs(get_config(aid))
        specs = spec_paths(sh.param_shardings(shapes, mesh()), shapes)
        for path, t in tensor_paths(shapes).items():
            s = specs[path]
            for dim, axes in zip(t.shape, s + (None,) * (t.dim() - len(s))):
                if axes is None:
                    continue
                axes = (axes,) if isinstance(axes, str) else axes
                assert dim % axis_size(mesh(), axes) == 0, (aid, path, s)


class TestBatchAndCache:
    def test_batch_sharded_over_dp(self):
        b = {"tokens": batch_specs(get_config("yi_6b"),
                                   SHAPES["train_4k"])["tokens"]}
        tree = sh.batch_shardings(b, mesh(multi=True), 256)
        assert tree["tokens"] == (("pod", "data"), None)

    def test_batch_of_one_replicated(self):
        b = {"tokens": batch_specs(get_config("yi_6b"),
                                   SHAPES["long_500k"])["tokens"]}
        assert tuple(b["tokens"].shape) == (1, 1)
        tree = sh.batch_shardings(b, mesh(), 1)
        assert tree["tokens"] == ()

    def test_gqa_cache_heads_not_divisible_uses_seq(self):
        cfg = get_config("qwen2_5_14b")               # kv heads = 8 < 16
        cache = cache_specs(cfg, SHAPES["decode_32k"])
        assert tuple(cache[0].shape) == (48, 128, 8, 32768, 128)
        s = sh.cache_shardings(cache, mesh(), 128, 32768, cfg)[0]
        assert norm(s[1]) == "data"                   # batch over data
        assert norm(s[3]) == "model"                  # seq picks up model

    def test_long500k_batch1_seq_sharded(self):
        cfg = get_config("zamba2_2_7b")
        cache = cache_specs(cfg, SHAPES["long_500k"])[1]
        assert tuple(cache[0].shape) == (9, 1, 32, 524288, 80)
        s = sh.cache_shardings(cache, mesh(), 1, 524288, cfg)[0]
        assert norm(s[2]) == "model"                  # 32 kv heads divide
        assert norm(s[3]) == "data"                   # SP over data

    def test_mla_latent_cache(self):
        cfg = get_config("deepseek_v2_lite_16b")
        cache = cache_specs(cfg, SHAPES["decode_32k"])[1]
        assert tuple(cache[0].shape) == (26, 128, 32768, 512)
        s = sh.cache_shardings(cache, mesh(), 128, 32768, cfg)[0]
        assert norm(s[1]) == "data"
        assert norm(s[2]) == "model"


# ---------------------------------------------------------------------------
# leaf by leaf against the JAX package

@functools.lru_cache(maxsize=None)
def jparams(aid):
    return jax_paths(jparams_specs(jget_config(aid)), raw=True)


@functools.lru_cache(maxsize=None)
def tparams(aid):
    return params_specs(get_config(aid))


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_param_spec_equals_jax_on_every_leaf(aid, mesh_name, fsdp):
    """Same paths, same shapes, same spec on every leaf."""
    want = {}
    for path, (raw, sds) in jparams(aid).items():
        stacked = any(n in ("layers", "prologue") for n in path)
        want[path] = (tuple(sds.shape), dtype_name(sds.dtype),
                      jspec(jsh.param_spec(raw, sds.shape, jmesh(mesh_name),
                                           fsdp=fsdp, stacked=stacked)))
    shapes = tparams(aid)
    specs = spec_paths(sh.param_shardings(shapes, abstract_mesh(
        *MESHES[mesh_name]), fsdp=fsdp), shapes)
    got = {path: (tuple(t.shape), dtype_name(t.dtype),
                  tuple(norm(e) for e in specs[path]))
           for path, t in tensor_paths(shapes).items()}
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("aid", ["yi_6b", "deepseek_v2_lite_16b",
                                 "dbrx_132b", "rwkv6_7b", "zamba2_2_7b"])
def test_opt_shardings_equal_jax(aid, mesh_name):
    """ZeRO: AdamW's m and v take the parameters' specs, its step count
    none, as JAX's ``opt_shardings`` gives them (FSDP on, as JAX's own
    call has it)."""
    cfg = get_config(aid)
    shapes = tparams(aid)
    m = abstract_mesh(*MESHES[mesh_name])
    with on_meta():
        state = adamw(3e-4).init(shapes)
    specs = spec_paths(sh.opt_shardings(state, None, m), state)
    jm = jmesh(mesh_name)
    raw = jparams(aid)
    for path, t in tensor_paths(state).items():
        if path[0] in ("m", "v"):
            sub = path[1:]
            want = jspec(jsh.param_spec(
                raw[sub][0], tuple(t.shape), jm,
                stacked=any(n in ("layers", "prologue") for n in sub)))
        else:
            want = ()
        assert tuple(norm(e) for e in specs[path]) == want, (cfg.name, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_batch_and_cache_specs_equal_jax(aid, shape, mesh_name):
    cfg, jcfg = get_config(aid), jget_config(aid)
    sp, jsp = SHAPES[shape], JSHAPES[shape]
    m, jm = abstract_mesh(*MESHES[mesh_name]), jmesh(mesh_name)
    batch = batch_specs(cfg, sp)
    jbatch = jbatch_specs(jcfg, jsp)
    assert {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in batch.items()} == \
        {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in jbatch.items()}
    got = sh.batch_shardings(batch, m, sp.global_batch)
    want = jsh.batch_shardings(jbatch, jm, jsp.global_batch)
    assert {k: tuple(map(norm, v)) for k, v in got.items()} == \
        {k: jspec(v.spec) for k, v in want.items()}
    cache = cache_specs(cfg, sp)
    jcache = jcache_specs(jcfg, jsp)
    specs = spec_paths(sh.cache_shardings(cache, m, sp.global_batch,
                                          sp.seq_len, cfg), cache)
    jspecs = jax_paths(jsh.cache_shardings(jcache, jm, jsp.global_batch,
                                           jsp.seq_len, jcfg))
    jshapes = jax_paths(jcache)
    got = {p: (tuple(t.shape), dtype_name(t.dtype), tuple(map(norm,
                                                              specs[p])))
           for p, t in tensor_paths(cache).items()}
    assert got == {p: (tuple(jshapes[p].shape), dtype_name(jshapes[p].dtype),
                       jspec(s.spec)) for p, s in jspecs.items()}


# ---------------------------------------------------------------------------
# specs as DTensor placements

@pytest.mark.parametrize("spec_,mesh_name,want", [
    ((("pod", "data"), None), "2x16x16",
     (Shard(0), Shard(0), Replicate())),
    (("data", "model"), "16x16", (Shard(0), Shard(1))),
    ((None, "data", None, ("model",), None), "16x16", (Shard(1), Shard(3))),
    ((None, None, None, ("pod", "data", "model"), None), "2x16x16",
     (Shard(3), Shard(3), Shard(3))),
    ((None, None, ("data", "model")), "16x16", (Shard(2), Shard(2))),
    ((), "2x16x16", (Replicate(), Replicate(), Replicate())),
])
def test_placements_of_a_spec(spec_, mesh_name, want):
    assert sh.placements(spec_, abstract_mesh(*MESHES[mesh_name])) == want


def test_placements_refuse_another_order_than_the_mesh():
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements((("data", "pod"), None), mesh(multi=True))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_every_multi_axis_entry_is_in_mesh_order(aid, mesh_name):
    """Every spec the rules give (params, batches, caches of every shape)
    converts; its multi-axis entries name the data axes, then 'model'."""
    cfg = get_config(aid)
    m = abstract_mesh(*MESHES[mesh_name])
    trees = [sh.param_shardings(tparams(aid), m)]
    for shape in SHAPES.values():
        trees.append(sh.batch_shardings(batch_specs(cfg, shape), m,
                                        shape.global_batch))
        cache = cache_specs(cfg, shape)
        trees.append(spec_paths(sh.cache_shardings(
            cache, m, shape.global_batch, shape.seq_len, cfg), cache))
    multi = 0
    for tree in trees:
        for s in by_path(tree).values():
            for e in s:
                if isinstance(e, tuple) and len(e) > 1:
                    multi += 1
                    assert list(e) == [a for a in (*data_axes(m), "model")
                                       if a in e]
            sh.placements(s, m)
    assert multi or mesh_name == "16x16"
