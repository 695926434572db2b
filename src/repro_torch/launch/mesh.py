"""Production mesh construction + the shared data-parallel axis spec
(PyTorch port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over a process
group the caller has set up (``make_production_mesh``), or an
:class:`AbstractMesh`, names and sizes alone, which needs no process group
(JAX's ``AbstractMesh`` needs no devices): the sharding rules read either.

:class:`AxisSpec` / :func:`shard_slices` are the mesh-tier language the DB
shard tier reuses: ``db/shard.py`` mirrors the ``data`` axis across N
database connections with exactly the partitioning a device mesh would
apply along its data axis, so a model trained in-DB with ``shards=N`` sees
the same per-shard batches as its dense data-parallel twin.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One named parallel axis — the piece of a mesh both tiers agree on."""

    name: str
    size: int

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"axis {self.name!r} needs size >= 1, "
                             f"got {self.size}")


def data_axis_spec(mesh) -> AxisSpec:
    """The mesh's data-parallel axis as a spec (pod × data collapsed)."""
    return AxisSpec("data", axis_size(mesh, data_axes(mesh)))


def shard_slices(n_rows: int, n_shards: int) -> list[slice]:
    """Deterministic contiguous partition of ``n_rows`` batch rows across
    ``n_shards``: shard k takes the k-th contiguous block, blocks differ
    by at most one row (the first ``n_rows % n_shards`` shards carry the
    extra).  Fixed order is load-bearing — the shard trainer's AllReduce
    and its determinism guarantee (shards=1 ≡ shards=N) both assume shard
    k always sees the same rows."""
    if n_shards < 1:
        raise ValueError(f"need n_shards >= 1, got {n_shards}")
    if n_rows < n_shards:
        raise ValueError(
            f"cannot partition {n_rows} rows across {n_shards} shards "
            f"(every shard needs at least one row)")
    base, extra = divmod(n_rows, n_shards)
    out, start = [], 0
    for k in range(n_shards):
        stop = start + base + (1 if k < extra else 0)
        out.append(slice(start, stop))
        start = stop
    return out


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no process group behind it."""

    shape: dict            # axis name → size, in mesh order
    axis_names: tuple

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def abstract_mesh(shape, axis_names) -> AbstractMesh:
    """An :class:`AbstractMesh` of ``shape`` (sizes) over ``axis_names``."""
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
    return AbstractMesh(dict(zip(axis_names, shape)), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) = (data, model), 256 ranks.  Multi-pod:
    (2, 16, 16) = (pod, data, model), 512 ranks.  A ``DeviceMesh`` over the
    default process group, which the caller has initialised with that many
    ranks (the dry-run's are placeholders: ``launch.dryrun``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') multi-pod, ('data',) single."""
    return tuple(n for n in axis_names(mesh) if n in ("pod", "data"))


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = (mesh.shape if isinstance(mesh, AbstractMesh)
             else dict(zip(axis_names(mesh), mesh.shape)))
    size = 1
    for n in names:
        size *= sizes[n]
    return size
