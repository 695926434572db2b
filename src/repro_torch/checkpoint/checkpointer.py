"""Sharded, async checkpointing with elastic restore, PyTorch port of
``repro.checkpoint.checkpointer``.

Layout, the JAX package's: ``<dir>/step_<N>/{manifest.json,
shard_<host>.npz}``, written into ``step_<N>.tmp`` and published by
``os.replace``; the oldest steps beyond ``keep`` are removed.  Leaves are
numbered in JAX's leaf order (``repro_torch.tree``: dict keys sorted at
each level), so ``leaf_i`` names the same tensor in both packages and a
checkpoint written by either restores in the other.  bf16 leaves are
stored as float32 (numpy has no bf16), which holds them exactly, and the
manifest keeps ``bfloat16`` as their type.

Async: ``save`` copies every leaf to host memory synchronously (the
device→host snapshot, so the caller may update the tensors in place right
after) and writes to disk on a background thread: the training loop waits
for the copy, not the I/O.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..tree import leaves, unflatten


def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of a leaf and the name of its type."""
    x = x.detach()
    name = str(x.dtype).removeprefix("torch.")
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy().copy(), name


class Checkpointer:
    def __init__(self, directory: str, host_id: int = 0, n_hosts: int = 1,
                 keep: int = 3):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot now, write async (set ``blocking`` for tests)."""
        self.wait()  # one outstanding write at a time
        host = [_to_host(x) for x in leaves(tree)]   # device→host snapshot
        host_leaves = [a for a, _ in host]
        dtypes = [name for _, name in host]

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            if self.host_id == 0:
                manifest = {
                    "step": step,
                    "n_leaves": len(host_leaves),
                    "n_hosts": self.n_hosts,
                    "treedef": _treedef(tree),
                    "shapes": [list(a.shape) for a in host_leaves],
                    "dtypes": dtypes,
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
            if os.path.exists(path):       # idempotent re-save of a step
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.replace(tmp, path)      # atomic publish
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, example_tree, step: int | None = None, device=None):
        """Rebuild the tree; ``example_tree`` supplies the structure, and
        each leaf's type and device (``device``, if given, places every
        leaf there instead).  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        data = np.load(os.path.join(path, f"shard_{self.host_id}.npz"))
        examples = leaves(example_tree)
        restored = []
        for i, ex in enumerate(examples):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(ex.shape):
                raise ValueError(f"leaf_{i}: checkpoint shape {a.shape}, "
                                 f"example {tuple(ex.shape)}")
            restored.append(torch.from_numpy(np.array(a)).to(
                device=ex.device if device is None else device,
                dtype=ex.dtype))
        return unflatten(example_tree, restored), step


def _treedef(tree) -> str:
    """A readable record of the tree's structure (the JAX package stores
    ``str(treedef)``; neither package reads it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"
