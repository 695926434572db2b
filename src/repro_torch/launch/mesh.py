"""The shared data-parallel axis spec (PyTorch port of the axis half of
``repro.launch.mesh``; pure Python, no ``torch.distributed``).

:class:`AxisSpec` / :func:`shard_slices` are the mesh-tier language the DB
shard tier reuses: ``db/shard.py`` mirrors the ``data`` axis across N
database connections with exactly the partitioning a device mesh would
apply along its data axis, so a model trained in-DB with ``shards=N`` sees
the same per-shard batches as its dense data-parallel twin.  Building a
device mesh over the cards is not part of this module.
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
