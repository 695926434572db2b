"""Data pipeline, PyTorch port of ``repro.data.pipeline``.

Two worlds, as in the JAX package:

1. The paper's datasets: Fisher's Iris (4 features, 3 classes, 150 rows)
   and MNIST-shaped image classification (784 features, 10 classes) as
   synthetic but structured stand-ins (separable Gaussian clusters) with
   the exact shapes the paper benchmarks.  They come from the same numpy
   RandomState stream as the JAX package, so the data is bit-identical;
   only the tensors' home differs.

2. LM token streams: a deterministic, host-shardable synthetic token
   source (``TokenPipeline``) and the stub frontends (EnCodec frames / ViT
   patches) of the ``[audio]``/``[vlm]`` entries.  Their numbers come from
   numpy's ``SeedSequence`` streams, not JAX's threefry keys, so the two
   packages draw different tokens from the same seed (a deliberate
   difference); the contract is the same.
"""
from __future__ import annotations

import dataclasses

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
    As ``jax.nn.one_hot`` does, a label outside 0..n_classes-1 (negative
    ones too) gets a zero row: the table is I_C with a zero row appended
    at index C, and every such label gathers that row."""
    dev = resolve(device)
    y = torch.as_tensor(y, device=dev).to(torch.int32)
    y = torch.where((y >= 0) & (y < n_classes), y, n_classes)
    table = torch.cat([torch.eye(n_classes, dtype=torch.float32, device=dev),
                       torch.zeros((1, n_classes), dtype=torch.float32,
                                   device=dev)])
    return ops.onehot_embed(y, table)


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic token stream, shardable across hosts:
    batch row r of step s is a pure function of (seed, s, r) (numpy's
    generator on ``SeedSequence([seed, s, r])``), so every host
    materialises exactly its shard, with no coordination, and a restart
    after a failure reproduces the same stream.  ``batch_at`` returns
    int32 ``tokens`` and ``labels`` (the next token), each (local_batch,
    seq_len), on ``device``."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = self.global_batch // self.n_hosts
        self._device = resolve(self.device)

    def _row(self, step: int, r: int) -> np.ndarray:
        """Row ``r`` of step ``step``: seq_len + 1 tokens."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, step, r]))
        return rng.integers(0, self.vocab, self.seq_len + 1, dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        row0 = self.host_id * self.local_batch
        toks = np.stack([self._row(step, r)
                         for r in range(row0, row0 + self.local_batch)])
        toks = torch.from_numpy(toks).to(self._device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def stub_frontend_batch(kind: str, batch_size: int, seq_len: int,
                        d_model: int, vocab: int, seed: int = 0,
                        device="cuda") -> dict:
    """Precomputed modality-frontend embeddings (the frontend is a STUB):
    ``embeds`` (B, S, d_model) float32 from N(0, 1) and int32 ``labels``
    (B, S), from numpy's generator on ``seed``, on ``device``.  ``kind``
    names the frontend and, as in the JAX package, changes nothing."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((batch_size, seq_len, d_model),
                                 dtype=np.float32)
    labels = rng.integers(0, vocab, (batch_size, seq_len), dtype=np.int32)
    return {"embeds": torch.from_numpy(embeds).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}
