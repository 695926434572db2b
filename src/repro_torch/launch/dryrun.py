"""Multi-pod dry-run: run every (architecture × input shape) on the
production meshes with placeholder ranks, record memory/cost/roofline
(PyTorch port of ``repro.launch.dryrun``).

No device is used and nothing is allocated.  One process joins a fake
process group of 256 or 512 ranks (``torch.distributed``'s "fake"
backend: collectives return at once) and plays rank 0.  The parameters,
the AdamW state, the batch and the caches are DTensors on the meta device
with the placements the sharding plan names (``launch.sharding``); the
train step (``train.trainer.make_train_step`` with ``adamw``),
``LM.prefill`` or ``LM.decode_step`` runs over them at full depth.  A cell
passes when the step runs through and every output the plan names a
placement for carries it (the train step's parameters and optimizer
state, decode's cache; prefill names none, as JAX's ``jit`` gives its
outputs none): the counterpart of JAX's compile succeeding.

The record keeps JAX's keys.  ``bytes_per_device.arguments`` / ``output``
are the exact bytes of the local shards the plan gives each input and
output; ``temp`` is the peak of the bytes the step's operations made and
still held, per device, over the full-depth run (a dispatch mode counts
each output in when made and out when freed: eager liveness, no reuse of
a fused executable's buffers).  FLOPs, bytes and wire bytes are per
device (``roofline.analysis.CostCounter``) and, as in JAX, extrapolated
from two shallow twins with the real widths, depth L1 and L2: total =
c(L1) + (n_units − 1)·(c(L2) − c(L1)), exact when the layers are
identical.  The kernels count themselves, their own formulas
(``kernels.meta``), so no scan correction is added here (JAX adds
``ssm_scan_corrections`` for the recurrences XLA counts once; the function
is kept for comparison).  These figures are modelled, not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
  ... --arch dbrx_132b --shape train_4k --mesh both              # one cell
  ... --set attn_impl=chunked --set moe.impl=shard               # knobs
  ... --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref

import torch
from torch.overrides import TorchFunctionMode

from ..configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..nn.model import LM
from ..optim.optimizers import adamw
from ..roofline.analysis import CostCounter, model_flops, roofline
from ..train.trainer import make_train_step
from .mesh import data_axes, make_production_mesh
from .sharding import (batch_shardings, cache_shardings, distribute,
                       opt_shardings, param_shardings, placements)
from .specs import batch_specs, cache_specs, on_meta, params_specs


def apply_overrides(cfg, overrides: dict):
    """--set key=value knobs; moe.*/ssm.* update the nested specs."""
    moe_kv = {k[4:]: v for k, v in overrides.items()
              if k.startswith("moe.")}
    ssm_kv = {k[4:]: v for k, v in overrides.items()
              if k.startswith("ssm.")}
    top_kv = {k: v for k, v in overrides.items() if "." not in k}
    if moe_kv and cfg.moe is not None:
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **moe_kv))
    if ssm_kv and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg,
                                  ssm=dataclasses.replace(cfg.ssm, **ssm_kv))
    if top_kv:
        cfg = dataclasses.replace(cfg, **top_kv)
    return cfg


def ssm_scan_corrections(cfg, shape, n_chips: int) -> tuple[float, float]:
    """JAX's analytic per-chip (flops, bytes) for recurrence steps hidden
    inside lax.scan bodies (counted once by XLA's cost analysis). RWKV-6
    time-mix state ops: ~5·H·N² FLOPs and 2·H·N²·4 B state traffic per
    token per layer; Mamba-2 inter-chunk recurrence: ~3·H·N·P per chunk
    per layer. Training multiplies by 3 (fwd + bwd recompute + grad
    accumulation of state).  The port's count needs none (the scan kernel
    counts itself and the Mamba-2 loop runs eagerly); kept for
    comparison with JAX's records."""
    if shape.kind == "decode":
        return 0.0, 0.0          # decode lowers one explicit step per layer
    tokens = shape.global_batch * shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    fl = by = 0.0
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.ssm.head_dim
        n = cfg.ssm.head_dim
        fl = 5.0 * h * n * n * tokens * cfg.n_layers * mult
        by = 2.0 * h * n * n * 4 * tokens * cfg.n_layers * mult
    elif cfg.family == "hybrid":
        h = cfg.n_heads_mamba()
        n, pdim = cfg.ssm.d_state, cfg.ssm.head_dim
        chunks = tokens / max(cfg.ssm.chunk, 1)
        fl = 3.0 * h * n * pdim * chunks * cfg.n_layers * mult
        by = 2.0 * h * n * pdim * 4 * chunks * cfg.n_layers * mult
    return fl / n_chips, by / n_chips


def placeholder_group(world: int) -> None:
    """The default process group as ``world`` placeholder ranks (the fake
    backend), this process rank 0; a group of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _forget_meshes()


def _forget_meshes() -> None:
    """Clear DTensor's caches of sharding propagation and redistribution
    plans: they hold the meshes of earlier groups, which compare equal to
    a new group's meshes of the same shape but name process groups that
    are gone."""
    from torch.distributed.tensor import DTensor, _redistribute, debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()
    else:
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
            .cache_clear()
    for name in ("clear_redistribute_planner_cache",):
        fn = getattr(_redistribute, name, None)
        if fn is not None:
            fn()
    gen = getattr(_redistribute, "_gen_transform_infos", None)
    if hasattr(gen, "cache_clear"):
        gen.cache_clear()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def _check_placed(tree, specs, mesh, what: str) -> None:
    """Every DTensor of ``tree`` carries its spec's placements."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_placed(v, specs[k], mesh, f"{what}/{k}")
        return
    if isinstance(tree, (tuple, list)):
        for i, (v, s) in enumerate(zip(tree, specs, strict=True)):
            _check_placed(v, s, mesh, f"{what}/{i}")
        return
    want = placements(specs, mesh)
    if not isinstance(tree, DTensor) or tuple(tree.placements) != want:
        got = tree.placements if isinstance(tree, DTensor) else type(tree)
        raise AssertionError(f"{what}: placed {got}, the plan names {want}")


def _redistribute(tree, specs, mesh):
    """Outputs resharded to the plan, as ``jit``'s out_shardings do."""
    if isinstance(tree, dict):
        return {k: _redistribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_redistribute(v, s, mesh)
                          for v, s in zip(tree, specs, strict=True))
    return tree.redistribute(mesh, placements(specs, mesh))


def build_step(cfg, shape, mesh, fsdp: bool = True, grad_accum: int = 1):
    """The entry point (train step / prefill / decode step) for ``cfg`` on
    ``mesh`` over DTensor inputs on meta with the production plan.
    Returns ``(run, args, out_specs)``: ``run(*args)`` runs it once and
    returns what the plan names placements for (``out_specs``, None for
    prefill), ``args`` the placed inputs.  ``grad_accum``: the train
    step's microbatches (JAX's dry-run runs one)."""
    lm = LM(cfg, device="meta")
    p_shapes = params_specs(cfg)
    psh = param_shardings(p_shapes, mesh, fsdp=fsdp)
    b_shapes = batch_specs(cfg, shape)
    bsh = batch_shardings(b_shapes, mesh, shape.global_batch)
    params = distribute(p_shapes, psh, mesh)
    batch = distribute(b_shapes, bsh, mesh)
    if shape.kind == "train":
        opt = adamw(3e-4, mixed_precision=cfg.param_dtype != "float32")
        with on_meta():
            o_shapes = opt.init(p_shapes)
        osh = opt_shardings(o_shapes, psh, mesh)
        step = make_train_step(lm.loss_fn, opt, grad_accum=grad_accum)

        def run(params, opt_state, batch):
            params, opt_state, _ = step(params, opt_state, batch)
            return (params, opt_state)

        return run, (params, distribute(o_shapes, osh, mesh), batch), \
            (psh, osh)
    if shape.kind == "prefill":
        return (lambda params, batch: lm.prefill(params, batch)[0],
                (params, batch), None)
    c_shapes = cache_specs(cfg, shape)
    csh = cache_shardings(c_shapes, mesh, shape.global_batch,
                          shape.seq_len, cfg)

    def decode(params, batch, cache):
        return _redistribute(lm.decode_step(params, batch, cache,
                                            shape.seq_len - 1)[1], csh, mesh)

    return decode, (params, batch, distribute(c_shapes, csh, mesh)), csh


_RESHAPES = {"reshape", "view", "flatten", "unflatten"}
# functions whose result is (a view or copy of) their first operand: a
# parameter's stays a parameter
_CARRY = {"unbind", "select", "to", "float",
          "bfloat16", "detach", "requires_grad_", "contiguous", "t",
          "transpose", "permute", "expand", "unsqueeze", "squeeze",
          "reshape", "view", "flatten", "unflatten", "chunk", "split"}


def _reshape(func, x, rest, kwargs):
    """``func(x, *rest)``, a reshape; where DTensor cannot run it on x's
    sharding (heads split from a dim whose shards do not hold whole
    heads), on x with that dim gathered, the batch dim's sharding kept;
    failing that, on x replicated."""
    from torch.distributed.tensor import Replicate, Shard

    try:
        return func(x, *rest, **kwargs)
    except RuntimeError:
        pass
    mesh = x.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    try:
        return func(x.redistribute(mesh, keep), *rest, **kwargs)
    except RuntimeError:
        return func(x.redistribute(mesh, [Replicate()] * mesh.ndim), *rest,
                    **kwargs)


class _Reshape(torch.autograd.Function):
    """A reshape whose gradient is reshaped back by the same rules
    (``_reshape``): autograd's own backward of a view is a view at the
    dispatch level, which DTensor refuses on the sharding the gradient
    arrives with as it refused the forward's."""

    @staticmethod
    def forward(ctx, x, run):
        ctx.shape = x.shape
        return run(x)

    @staticmethod
    def backward(ctx, g):
        return g.reshape(ctx.shape), None


# products, and gathers from a sharded dim: a partial sum they leave (a
# contraction over a sharded dim; the gold logit from vocab-sharded
# logits) is summed where it is made, as GSPMD sums a row-parallel
# product's
_PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "einsum", "bmm", "mm",
             "linear", "gather"}


class _AtUse(TorchFunctionMode):
    """What ``jit`` with the plan's shardings does by itself and DTensor
    does not:

    - FSDP: a parameter sharded over the data axes is gathered over them
      where the forward uses it (the all-gather at use; autograd's
      reduce-scatter of its gradient comes with it).  DTensor would
      otherwise choose by its own cost model, and may gather the batch
      instead.  The optimizer (no grad mode) updates the shards in place.
    - A reshape DTensor cannot run on its sharding runs by ``_reshape``'s
      rules, forward and backward (``_Reshape``).
    - An activation sharded over 'model' on the dim a column-parallel
      weight contracts is gathered first (Megatron's all-gather), not the
      weight resharded to the activation's split, whose partial sums would
      then make the product's output (the logits) whole on every rank.
    - A product's partial sums are summed at once (the all-reduce after a
      row-parallel product), not carried into the next operations, which
      would then run on each rank at full width; so are integer partial
      sums (counts), which DTensor would otherwise divide into floats to
      add a replicated operand to them.
    - An embedding lookup in a vocab-sharded table runs vocab-parallel
      (``_lookup``), and so do the loss's logsumexp and gold-logit gather
      over vocab-sharded logits (``_logsumexp``, ``_gather_sharded``):
      DTensor would gather the vocab, or build the gather's gradient at
      the global shape on every rank.
    GSPMD inserts such reshardings itself."""

    def __init__(self, params):
        super().__init__()
        from ..tree import leaves
        self.ids: set[int] = set()
        for t in leaves(params):
            self._tag(t)

    def _tag(self, t) -> None:
        if id(t) not in self.ids:
            self.ids.add(id(t))
            weakref.finalize(t, self.ids.discard, id(t))

    def _gather(self, x):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if not isinstance(x, DTensor) or id(x) not in self.ids:
            return x
        names = x.device_mesh.mesh_dim_names
        want = [Replicate() if n != "model" and isinstance(p, Shard) else p
                for n, p in zip(names, x.placements)]
        return x.redistribute(x.device_mesh, want)

    def _backward(self, loss, gradient=None, **_):
        """``loss.backward()`` with this mode in force inside it (a mode
        is not, inside its own handler), so that remat's recompute runs
        under the same rules as the forward."""
        from torch.autograd.graph import _engine_run_backward

        with self:
            grad = torch.ones_like(loss) if gradient is None else gradient
            _engine_run_backward((loss,), (grad,), False, False, (),
                                 allow_unreachable=True,
                                 accumulate_grad=True)

    @staticmethod
    def _model_sharded(x, dim) -> bool:
        dim = dim % x.dim()
        return any(n == "model" and p.is_shard(dim) for n, p in zip(
            x.device_mesh.mesh_dim_names, x.placements))

    @staticmethod
    def _model_gathered(x):
        """x with its 'model' sharding gathered, the rest kept."""
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        return x.redistribute(mesh, [
            Replicate() if n == "model" else p
            for n, p in zip(mesh.mesh_dim_names, x.placements)])

    @staticmethod
    def _logsumexp(x, dim, keepdim=False):
        """Over a vocab-sharded dim: each rank's max and sum of
        exponentials, combined over 'model' (DTensor would gather the
        vocab first).  The max is a constant of the gradient (it cancels),
        so it is detached."""
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        keep = [Replicate() if n == "model" else p
                for n, p in zip(mesh.mesh_dim_names, x.placements)]
        m = torch.amax(x.detach(), dim=dim, keepdim=True).redistribute(
            mesh, keep)
        s = torch.sum(torch.exp(x - m), dim=dim, keepdim=True).redistribute(
            mesh, keep)
        out = m + torch.log(s)
        return out if keepdim else out.squeeze(dim)

    def _gather_sharded(self, x, dim, index):
        """``torch.gather`` along a vocab-sharded dim: each rank picks the
        indices in its range (zeros elsewhere), summed over 'model'."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        dim = dim % x.dim()
        i_pl = [p if n != "model" else Replicate()
                for n, p in zip(names, x.placements)]
        if not isinstance(index, DTensor):
            index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)

        def local(t, i):
            j = i - mesh.get_local_rank("model") * t.shape[dim]
            hit = (j >= 0) & (j < t.shape[dim])
            return torch.gather(t, dim, torch.where(hit, j, 0)) * hit

        o_pl = [Partial() if n == "model" else p
                for n, p in zip(names, i_pl)]
        out = local_map(local, out_placements=o_pl,
                        in_placements=(list(x.placements), i_pl),
                        device_mesh=mesh, redistribute_inputs=True)(x, index)
        return out.redistribute(mesh, i_pl)

    def _lookup(self, table, ids):
        """``table[ids]`` as GSPMD runs an embedding over a vocab-sharded
        table: each rank looks up the ids in its vocab range (zeros
        elsewhere), the partial rows are summed over 'model', and the
        rows keep the ids' batch sharding."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = table.device_mesh
        names = mesh.mesh_dim_names
        split = any(n == "model" and isinstance(p, Shard) and p.dim == 0
                    for n, p in zip(names, table.placements))
        t_pl = [Shard(0) if n == "model" and split else Replicate()
                for n in names]
        i_pl = [p if n != "model" else Replicate()
                for n, p in zip(names, ids.placements)]

        def local(t, i):
            if not split:
                return t[i]
            j = i - mesh.get_local_rank("model") * t.shape[0]
            hit = (j >= 0) & (j < t.shape[0])
            return t[torch.where(hit, j, 0)] * hit[..., None].to(t.dtype)

        o_pl = [Partial() if n == "model" and split else p
                for n, p in zip(names, i_pl)]
        out = local_map(local, out_placements=o_pl, in_placements=(t_pl,
                                                                   i_pl),
                        device_mesh=mesh, redistribute_inputs=True)(table,
                                                                    ids)
        return out.redistribute(mesh, i_pl)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "backward":
            return self._backward(*args, **kwargs)
        if name in ("logsumexp", "gather") and isinstance(args[0], DTensor):
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            if self._model_sharded(args[0], dim):
                return (self._logsumexp if name == "logsumexp"
                        else self._gather_sharded)(*args, **kwargs)
        if name == "__getitem__" and id(args[0]) in self.ids and \
                isinstance(args[1], DTensor) and args[0].dim() == 2 and \
                not args[1].is_floating_point():
            return self._lookup(*args)
        if name in _CARRY:
            x = args[0] if args else None
            if name in _RESHAPES and isinstance(x, DTensor):
                run = lambda t: _reshape(func, t, args[1:], kwargs)
                out = (_Reshape.apply(x, run)
                       if torch.is_grad_enabled() and x.requires_grad
                       else run(x))
            else:
                out = func(*args, **kwargs)
            if args and id(args[0]) in self.ids:
                for t in (out if isinstance(out, (tuple, list))
                          else (out,)):
                    if isinstance(t, torch.Tensor):
                        self._tag(t)
            return out
        if name in _PRODUCTS and len(args) == 2 and \
                id(args[1]) in self.ids and isinstance(args[0], DTensor) and \
                self._model_sharded(args[0], -1) and \
                self._model_sharded(args[1], -1):
            args = (self._model_gathered(args[0]), args[1])
        if torch.is_grad_enabled() and not name.endswith("_"):
            args = tuple(self._gather(a) for a in args)
        out = func(*args, **kwargs)
        if isinstance(out, DTensor) and (
                name in _PRODUCTS or not out.is_floating_point()) and any(
                p.is_partial() for p in out.placements):
            out = out.redistribute(out.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in out.placements])
        return out


@contextlib.contextmanager
def _alltoall_as_on_cards():
    """On a CPU mesh DTensor sends a shard-to-shard redistribution as an
    all-gather and a chunk (gloo has no all-to-all); on the cards' mesh it
    is one all-to-all, and so it is run, and counted, here."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    saved = [(m, m.shard_dim_alltoall)
             for m in (_collective_utils, placement_types)
             if hasattr(m, "shard_dim_alltoall")]
    for m, _ in saved:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in saved:
            m.shard_dim_alltoall = fn


def _run(cfg, shape, mesh, fsdp: bool, grad_accum: int = 1):
    """One run of the step under a CostCounter: (counter, outputs, args,
    out_specs)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..nn.moe import set_moe_mesh

    run, args, out_specs = build_step(cfg, shape, mesh, fsdp, grad_accum)
    set_moe_mesh(mesh, data_axes(mesh))     # impl='shard' engine support
    try:
        with implicit_replication(), _alltoall_as_on_cards(), \
                _AtUse(args[0]), CostCounter() as counter:
            out = run(*args)
    finally:
        set_moe_mesh(None, None)
    return counter, out, args, out_specs


def measure_costs(cfg, shape, mesh, fsdp: bool, grad_accum: int = 1):
    """Per-device FLOPs, bytes, wire bytes and collectives by kind,
    extrapolated in depth from two shallow twins with the real widths
    (depth L1 and L2): total = c(L1) + (n_units − 1)·(c(L2) − c(L1)).
    Embedding / LM head / loss land in the base term of both."""
    pro = cfg.moe.first_k_dense if cfg.moe else 0
    step = cfg.shared_attn_every if cfg.family == "hybrid" else 1
    l1, l2 = pro + step, pro + 2 * step
    n_units = (cfg.n_layers - pro) // step
    out = []
    for lv in (l1, l2):
        counter = _run(dataclasses.replace(cfg, n_layers=lv), shape, mesh,
                       fsdp, grad_accum)[0]
        out.append((counter.flops, counter.bytes, counter.stats()))
    (f1, b1, c1), (f2, b2, c2) = out
    k = n_units - 1
    flops = f1 + k * (f2 - f1)
    hbm = b1 + k * (b2 - b1)
    wire = c1.wire_bytes + k * (c2.wire_bytes - c1.wire_bytes)
    by_kind = {}
    z = {"count": 0, "bytes": 0.0, "wire": 0.0}
    for kd in set(c1.by_kind) | set(c2.by_kind):
        a, b = c1.by_kind.get(kd, z), c2.by_kind.get(kd, z)
        by_kind[kd] = {m: a[m] + k * (b[m] - a[m])
                       for m in ("count", "bytes", "wire")}
    return flops, hbm, wire, by_kind


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None, fsdp: bool = True,
               cfg=None, shape=None):
    """Returns (record dict, outputs) for one (arch × shape × mesh) cell.

    The FULL model runs over the placed meta inputs: its running through,
    with every planned output placed as planned, is the pass/fail
    criterion, and supplies the bytes per device.  FLOP/byte/collective
    rates come from measure_costs (depth-extrapolated).  ``cfg`` and
    ``shape`` replace the arch's config and the named shape (a test's
    reduced ones)."""
    cfg = cfg or get_config(arch_id)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    shape = shape or SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    if not shape_applicable(cfg, shape):
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skip (full attention)"}, None
    placeholder_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    t0 = time.time()
    counter, outputs, args, out_specs = _run(cfg, shape, mesh, fsdp)
    if out_specs is not None:
        _check_placed(outputs, out_specs, mesh, "output")
    flops, hbm, wire, by_kind = measure_costs(cfg, shape, mesh, fsdp)
    dt = time.time() - t0
    arg_bytes = _local_bytes(args)
    out_bytes = _local_bytes(outputs)
    # the train step and decode update their inputs in place (JAX donates
    # them), so their outputs alias the arguments
    aliased = out_bytes if shape.kind != "prefill" else 0
    rl = roofline(flops, hbm, wire, model_flops(cfg, shape, n_chips),
                  by_kind)
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "compile_s": round(dt, 1),
        "overrides": overrides or {},
        "bytes_per_device": {
            "arguments": arg_bytes,
            "output": out_bytes,
            "temp": counter.peak,
            "aliased": aliased,
            "peak_extra": counter.peak,
            "total_live": arg_bytes + out_bytes + counter.peak - aliased,
        },
        "flops_per_device": rl.flops,
        "hbm_bytes_per_device": rl.hbm_bytes,
        "wire_bytes_per_device": rl.wire_bytes,
        "collectives": rl.collectives,
        "terms_s": {"compute": rl.compute_s, "memory": rl.memory_s,
                    "collective": rl.collective_s},
        "bottleneck": rl.bottleneck,
        "model_flops_per_device": rl.model_flops,
        "useful_flop_ratio": round(rl.useful_ratio, 4),
        "roofline_fraction": round(rl.roofline_fraction, 4),
    }
    return record, outputs


def run_cells(archs, shapes, meshes, overrides=None, out_path=None,
              fsdp=True, verbose=True):
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} × {shape} × {_mesh_name(mp)}"
                try:
                    rec, _ = lower_cell(arch, shape, multi_pod=mp,
                                        overrides=overrides, fsdp=fsdp)
                except Exception as e:  # a failure here is a system bug
                    rec = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(mp),
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    if verbose:
                        traceback.print_exc()
                records.append(rec)
                if verbose:
                    st = rec["status"]
                    extra = ""
                    if st == "ok":
                        t = rec["terms_s"]
                        extra = (f" [{rec['bottleneck']}] "
                                 f"c={t['compute']:.3g}s m={t['memory']:.3g}s"
                                 f" x={t['collective']:.3g}s "
                                 f"compile={rec['compile_s']}s")
                    print(f"{tag:58s} {st}{extra}", flush=True)
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(records, f, indent=1)
    return records


def main():
    import logging
    # DTensor warns about every redistribution it finds suboptimal; the
    # dry-run counts them instead
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="cfg override key=value (e.g. attn_impl=chunked)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    overrides = {}
    for s in args.sets:
        k, v = s.split("=", 1)
        overrides[k] = (int(v) if v.isdigit() else
                        (float(v) if v.replace(".", "").isdigit() else v))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.time()
    recs = run_cells(args.arch, args.shape, meshes, overrides or None,
                     args.out, fsdp=not args.no_fsdp)
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"].startswith("skip") for r in recs)
    n_fail = len(recs) - n_ok - n_skip
    print(f"\n{n_ok} ok / {n_skip} skip / {n_fail} FAIL of {len(recs)} "
          f"in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
