"""Three-term roofline from a dry-run's counted step (no hardware): PyTorch
port of ``repro.roofline.analysis``, with Hopper's constants.

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = wire_bytes_per_device / link_bw

The JAX package reads FLOPs and bytes from XLA's cost analysis of the
partitioned executable and parses its collectives out of the HLO text.
Here the step runs eagerly on meta tensors (``launch.dryrun``) under
:class:`CostCounter`, a dispatch mode that sees every operation a device
would run on its own shard:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: the products, convolutions and attention), applied to the
  local operands.  ``FlopCounterMode`` itself over DTensors counts each
  operation at its global shape, so the counter takes DTensor operations
  apart (it declines them; DTensor then runs the local operations, which
  it counts).  The kernels' entry points add their own count
  (:func:`add_kernel_cost`), the formula of their bound.
* Bytes: each operation's tensor operands plus its outputs, views and
  allocations excepted.  The port runs eagerly, so these are unfused
  bytes; XLA's are those of its fused executable, fewer.
* Collectives: the functional collectives DTensor issues (kind, result
  bytes, group size), converted to wire bytes with ring-algorithm factors:

    all-reduce      2·(g−1)/g · bytes      (reduce-scatter + all-gather)
    all-gather      (g−1)/g · result
    reduce-scatter  (g−1)   · result       (operand = g · result)
    all-to-all      (g−1)/g · bytes
    collective-permute  1 · bytes

* Memory: the peak of the bytes the counted operations made that are
  still alive (outputs counted in when made, out when freed).

DTensor propagates a sharding by running the operation once on meta
tensors of the global shape; it caches the result per operation and
input specs, so a count is read from a second run of the same step, in
which no propagation runs (``launch.dryrun`` does so).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 data sheet (dense, no sparsity): the counterparts of
# the TPU v5e constants of the JAX package (197 TFLOP/s bf16, 819 GB/s).
PEAK_FLOPS = 989e12        # bf16 on the tensor cores, per GPU
PEAK_FLOPS_TF32 = 495e12   # TF32 on the tensor cores (for readers)
PEAK_FLOPS_F32 = 67e12     # float32 outside the tensor cores (for readers)
HBM_BW = 3.35e12           # bytes/s per GPU (HBM3)
# A 16 × 16 mesh's groups span nodes of 8 GPUs: between nodes each GPU has
# one 400 Gb/s NDR InfiniBand port (DGX H100), 50e9 bytes/s.
LINK_BW = 50e9             # bytes/s per GPU across nodes

_KINDS = {"all_reduce": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}

# operations that move no bytes: they make a view or an uninitialised
# tensor, or only wait
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "wait_tensor", "_wrap_tensor_autograd", "_to_copy_meta"}


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """A collective's bytes on the wire per device, by the ring factors."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * nbytes
    if kind == "reduce-scatter":
        return float(g - 1) * nbytes
    return float(nbytes)                      # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    by_kind: dict
    wire_bytes: float      # per-device bytes crossing links

    def total_result_bytes(self) -> float:
        return sum(v["bytes"] for v in self.by_kind.values())


def collective_stats(records) -> CollectiveStats:
    """(kind, result bytes, group size) records → per-kind count, bytes
    and wire bytes, and their wire total."""
    by_kind: dict[str, dict] = {}
    wire = 0.0
    for kind, nbytes, g in records:
        w = wire_bytes(kind, nbytes, g)
        rec = by_kind.setdefault(kind, {"count": 0, "bytes": 0.0,
                                        "wire": 0.0})
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire"] += w
        wire += w
    return CollectiveStats(by_kind=by_kind, wire_bytes=wire)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    name = func.__name__.split(".")[0]
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _propagating() -> bool:
    """Whether the caller is DTensor's sharding propagation, which runs an
    operation on meta tensors of the global shape to learn its output's
    (no device runs that)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


#: the counter in force (``CostCounter.__enter__``), for the kernels' own
#: counts
_ACTIVE: list = []


def add_kernel_cost(flops: float, n_bytes: float) -> None:
    """A kernel entry point's shape-only path adds the FLOPs and bytes of
    the call it stands for (per device: the local shapes)."""
    if _ACTIVE:
        _ACTIVE[-1].flops += flops
        _ACTIVE[-1].bytes += n_bytes


class CostCounter(TorchDispatchMode):
    """Counts, per device, what the operations run inside it would cost:
    ``flops``, ``bytes`` (operands + outputs), ``collectives`` (kind,
    result bytes, group size) and ``peak`` (live bytes made inside).  A
    local view that the strides of its operand do not allow (DTensor's
    einsum backward, on a shard its all-to-all left non-contiguous) runs
    as a reshape, a copy, and is counted as one."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, float, int]] = []
        self.live = 0
        self.peak = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs the local operations
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            # DTensor's einsum backward views a shard that its all-to-all
            # left non-contiguous: a copy is what that view would need
            if func is not torch.ops.aten.view.default:
                raise
            func = torch.ops.aten.reshape.default
            out = func(*args, **kwargs)
        if _propagating():
            return out
        name = func.__name__.split(".")[0]
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if name in _KINDS:
            self.collectives.append((_KINDS[name],
                                     float(sum(map(_nbytes, _tensors(out)))),
                                     _group_size(func, args)))
        if func.is_view or name in _FREE:
            return out
        ins = sum(map(_nbytes, _tensors((args, kwargs))))
        made = list(_tensors(out))
        self.bytes += ins + sum(map(_nbytes, made))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out                   # in place: no new storage
        for t in made:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._freed, n)
        self.peak = max(self.peak, self.live)
        return out

    def stats(self) -> CollectiveStats:
        return collective_stats(self.collectives)


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    wire_bytes: float             # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0      # 6·N·D (per device share)
    collectives: dict | None = None

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modelled step
        time: MODEL_FLOPS / (peak · step_time)."""
        return (self.model_flops / PEAK_FLOPS) / self.step_s \
            if self.step_s else 0.0


def roofline(flops: float, hbm: float, wire: float,
             model_flops_per_device: float = 0.0,
             collectives: dict | None = None) -> Roofline:
    terms = {"compute": flops / PEAK_FLOPS, "memory": hbm / HBM_BW,
             "collective": wire / LINK_BW}
    return Roofline(flops=flops, hbm_bytes=hbm, wire_bytes=wire,
                    compute_s=terms["compute"], memory_s=terms["memory"],
                    collective_s=terms["collective"],
                    bottleneck=max(terms, key=terms.get),
                    model_flops=model_flops_per_device,
                    collectives=collectives)


def model_flops(cfg, shape, n_chips: int) -> float:
    """MODEL_FLOPS per device: 6·N·D for training (fwd+bwd), 2·N·D for
    inference, with N = active params (MoE: routed top-k + shared)."""
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else (shape.seq_len if shape.kind ==
                                         "prefill" else 1))
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens / n_chips
