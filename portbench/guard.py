"""The import guard: no module of JAX, or of the JAX package ``repro``,
may be loaded in the process that prints a result."""
from __future__ import annotations

import sys

#: top-level module names (the part before the first dot), compared whole:
#: ``repro_torch`` is the port and not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

