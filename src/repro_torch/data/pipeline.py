"""The paper's datasets, PyTorch port of the paper half of
``repro.data.pipeline``.

Fisher's Iris (4 features, 3 classes, 150 rows) and MNIST-shaped image
classification (784 features, 10 classes) as synthetic but structured
stand-ins (separable Gaussian clusters) with the exact shapes the paper
benchmarks.  They come from the same numpy RandomState stream as the JAX
package, so the data is bit-identical; only the tensors' home differs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops


def make_iris(n_rows: int = 150, seed: int = 0, device="cuda"):
    """4 features scaled to [0, 1] (paper divides by 10), 3 classes."""
    dev = resolve(device)
    rng = np.random.RandomState(seed)
    per = n_rows // 3
    centers = rng.rand(3, 4) * 0.6 + 0.2
    xs, ys = [], []
    for c in range(3):
        n = per if c < 2 else n_rows - 2 * per
        xs.append(centers[c] + rng.randn(n, 4) * 0.05)
        ys.append(np.full((n,), c, np.int32))
    x = np.clip(np.concatenate(xs), 0, 1).astype(np.float32)
    y = np.concatenate(ys)
    order = rng.permutation(n_rows)
    return torch.from_numpy(x[order]).to(dev), torch.from_numpy(y[order]).to(dev)


def make_mnist_like(n_rows: int = 6000, seed: int = 0, device="cuda"):
    """784 features in [0,1], 10 classes (paper uses a 6000-tuple excerpt)."""
    dev = resolve(device)
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 784).astype(np.float32)
    y = rng.randint(0, 10, n_rows).astype(np.int32)
    x = protos[y] * 0.5 + rng.rand(n_rows, 784).astype(np.float32) * 0.5
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def replicate(x, y, factor: int):
    """Paper §6.2: 'we replicate the Iris flower data set … to enable a
    flexible input size'."""
    return torch.cat([x] * factor, dim=0), torch.cat([y] * factor, dim=0)


def one_hot_labels(y, n_classes: int, device="cuda") -> torch.Tensor:
    """§4.1's label transform: ``onehot(y) · I_C``, the one-hot row gather
    with the identity as table (the ``onehot_embed`` kernel on the card).
    A label outside 0..n_classes-1 raises (the JAX package's
    ``jax.nn.one_hot`` gives it a zero row)."""
    dev = resolve(device)
    y = torch.as_tensor(y, device=dev).to(torch.int32)
    return ops.onehot_embed(y, torch.eye(n_classes, dtype=torch.float32,
                                         device=dev))
