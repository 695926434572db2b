"""Hand-written Hopper (sm_90a) CUDA kernels for the paper's hot spots.

Each kernel: ``csrc/<name>.cu`` (built at first use by ``build``), its
ctypes wrapper ``<name>.py`` with a launch counter and its plain twin
``plain``, the device dispatch in ``ops.py``, and the plain PyTorch
versions in ``ref.py``.  The optimizer tail's (``adamw.py``) is
dispatched by ``optim/optimizers.py``, whose per-leaf code is its plain
twin.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
