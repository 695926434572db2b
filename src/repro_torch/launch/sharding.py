"""Sharding rules: params (TP + FSDP), optimizer state (ZeRO), batches,
and serving caches, for every architecture family (PyTorch port of
``repro.launch.sharding``).

Parallelism map (DESIGN.md §5):
  * DP    — batch over ('pod', 'data')
  * TP    — attention heads / FFN hidden / vocab over 'model'
  * EP    — routed experts over 'model'
  * SP    — KV-cache sequence over spare axes when batch/heads don't divide
  * FSDP  — weight dim-0 over 'data' (within-pod only; cross-pod stays
            replicated so DCI never carries weight gathers)
  * ZeRO  — optimizer state inherits the param sharding (elementwise update)

Rules are name-based over the param tree; any dim is sharded only when
divisible by the axis size, so one rule set covers all ten configs.

A spec is a tuple with one entry per tensor dim, JAX's ``PartitionSpec``:
None, an axis name, or a tuple of axis names (the dim sharded over them
in that order, the first outermost).  :func:`placements` turns one into
DTensor placements on a ``DeviceMesh``.  DTensor shards a dim that several
mesh dims split in mesh order, so a multi-axis entry must list its axes
in the mesh's order (every rule here does: the data axes, then 'model');
:func:`placements` raises where one does not.
"""
from __future__ import annotations

from typing import Any

from .mesh import axis_names, axis_size, data_axes

# leaf-name → which dim prefers the 'model' axis (before any leading L axis)
_COL = {"wq", "wk", "wv", "wg", "wi", "wkv_a", "wk_b", "wv_b", "wk_rope",
        "in_proj", "lm_head", "wr", "conv_w"}     # output-dim sharded (last)
_ROW = {"wo", "out_proj"}                          # contraction-dim (first)
_EXPERT = {"wi", "wg", "wo"}                       # under a "moe" parent: dim 0
_VOCAB = {"embed"}                                 # dim 0 (vocab)
_REPLICATED = {"w0", "u", "a_log", "dt_bias", "d_skip", "mu", "mu_k", "mu_r",
               "w_lora_a", "w_lora_b", "router", "bq", "bk", "bv", "bi", "bo",
               "b"}


def _path_names(path) -> list[str]:
    """A path's names: strings and ints as they are, or JAX's key entries
    (``.key`` / ``.idx``)."""
    out = []
    for k in path:
        if isinstance(k, (str, int)):
            out.append(str(k))
        elif hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
    return out


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists, the path
    a tuple of dict keys and sequence indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def param_spec(path, shape: tuple[int, ...], mesh, *, fsdp: bool = True,
               stacked: bool = False) -> tuple:
    names = _path_names(path)
    leaf = names[-1] if names else ""
    model_n = axis_size(mesh, "model")
    data_n = axis_size(mesh, "data")
    off = 1 if stacked else 0          # leading L axis of scanned stacks
    nd = len(shape)
    spec: list[Any] = [None] * nd
    body = list(range(off, nd))
    if not body:
        return ()

    model_dim = None
    if "moe" in names and leaf in _EXPERT and nd - off == 3:
        model_dim = body[0]            # expert parallelism
    elif leaf in _VOCAB:
        model_dim = body[0]
    elif leaf in _ROW:
        model_dim = body[0]
    elif leaf in _COL and leaf not in _REPLICATED:
        model_dim = body[-1]
    if (model_dim is not None and
            _divisible(shape[model_dim], model_n)):
        spec[model_dim] = "model"
    else:
        model_dim = None

    if fsdp and nd - off >= 2:
        # FSDP: biggest remaining dim divisible by the in-pod data axis
        cands = sorted((d for d in body if d != model_dim),
                       key=lambda d: -shape[d])
        for d in cands:
            if _divisible(shape[d], data_n) and shape[d] >= data_n * 8:
                spec[d] = "data"
                break
    return tuple(spec)


def _stacked(names) -> bool:
    return any(n in ("layers", "prologue") for n in names)


def param_shardings(params_shapes, mesh, *, fsdp: bool = True):
    """Tree of meta tensors (or anything with ``.shape``) → tree of specs
    (same structure)."""

    def one(path, leaf):
        return param_spec(path, tuple(leaf.shape), mesh, fsdp=fsdp,
                          stacked=_stacked(_path_names(path)))

    return _map_with_path(one, params_shapes)


def opt_shardings(opt_shapes, param_sh, mesh):
    """ZeRO: m/v mirror the param shardings; scalars replicated."""

    def one(path, leaf):
        names = _path_names(path)
        if names and names[0] in ("m", "v", "master"):
            sub = path[1:]
            return param_spec(sub, tuple(leaf.shape), mesh,
                              stacked=_stacked(_path_names(sub)))
        return ()

    return _map_with_path(one, opt_shapes)


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------

def batch_shardings(batch_shapes, mesh, global_batch: int):
    dp = data_axes(mesh)
    dp_n = axis_size(mesh, dp)
    bspec = dp if _divisible(global_batch, dp_n) else None

    def one(leaf):
        nd = len(leaf.shape)
        if nd >= 1 and leaf.shape[0] == global_batch and bspec:
            return (bspec, *([None] * (nd - 1)))
        return ()

    return _map(one, batch_shapes)


def cache_shardings(cache_shapes, mesh, batch_size: int, max_len: int,
                    cfg) -> Any:
    """KV caches / recurrent states. Priority: batch over DP axes; heads
    over 'model' when divisible; otherwise the sequence dim picks up the
    unused axis (sequence parallelism — flash-decoding style)."""
    dp = data_axes(mesh)
    dp_n = axis_size(mesh, dp)
    model_n = axis_size(mesh, "model")
    batch_ok = _divisible(batch_size, dp_n) and batch_size >= dp_n

    def one(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list[Any] = [None] * nd
        # dim 0 is the layer stack; identify batch / sequence / head dims
        batch_dim = None
        if batch_size > 1:
            batch_dim = next((i for i in range(1, nd)
                              if shape[i] == batch_size), None)
        seq_dim = next((i for i in range(1, nd)
                        if shape[i] == max_len and i != batch_dim), None)
        head_dim = None
        for i in range(1, nd - 1):                 # last dim = feature width
            if i in (batch_dim, seq_dim):
                continue
            if _divisible(shape[i], model_n) and shape[i] >= model_n:
                head_dim = i
                break
        if batch_dim is not None and batch_ok:
            spec[batch_dim] = dp
        if head_dim is not None:
            spec[head_dim] = "model"
        if seq_dim is not None:                    # SP picks up free axes
            free: list[str] = []
            if batch_dim is None or not batch_ok:
                free += list(dp)
            if head_dim is None:
                free.append("model")
            size = 1
            for a in free:
                size *= axis_size(mesh, a)
            if free and _divisible(shape[seq_dim], size):
                spec[seq_dim] = tuple(free)
        return tuple(spec)

    return _map(one, cache_shapes)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """A spec → one DTensor placement per mesh dim: ``Shard(d)`` where
    tensor dim d names that mesh dim, else ``Replicate()``.  A dim split
    over several axes must list them in mesh order (DTensor's order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: dim {d} lists {axes}, not in the "
                             f"mesh's order {names}; DTensor would shard "
                             "it in another order than JAX")
        for i in at:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each meta tensor of ``tree`` as a DTensor on ``mesh`` with its
    spec's placements (``specs`` a tree of the same structure)."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, x) for v, x in zip(t, s, strict=True))
        return distribute_tensor(t, mesh, placements(s, mesh))

    return walk(tree, specs)
