"""Meta-device stand-ins for every model input (no allocation): PyTorch
port of ``repro.launch.specs``.

``batch_specs(cfg, shape)`` returns the batch for the shape's kind:
  train    {tokens|embeds, labels}          (global_batch, seq)
  prefill  {tokens|embeds}                  (global_batch, seq)
  decode   {tokens|embeds} one new token + KV cache of seq_len

``params_specs`` and ``cache_specs`` run ``LM.init`` / ``LM.init_cache``
with every tensor made on the meta device (:func:`on_meta`), the
counterpart of ``jax.eval_shape``: the trees have JAX's structure, shapes
and dtypes, and no storage.  Stub frontends ([audio]/[vlm]) provide
precomputed frame/patch embeddings, per the assignment.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from ..configs.base import ArchConfig, ShapeSpec
from ..nn.model import LM


class _OnMeta(TorchFunctionMode):
    """Every ``device=`` a torch function is given becomes the meta device
    (factories, ``randn`` with a CPU generator, ``.to(device)``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


@contextlib.contextmanager
def on_meta():
    """Inside, tensors are made on the meta device whatever device the
    code names: shapes and dtypes only, nothing allocated."""
    with _OnMeta(), torch.device("meta"):
        yield


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    meta = dict(device="meta")
    if cfg.stub_frontend:
        batch = {"embeds": torch.empty((b, s, cfg.d_model),
                                       dtype=torch.float32, **meta)}
    else:
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, **meta)
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    lm = LM(cfg, device="cpu")
    with on_meta():
        return lm.init_cache(shape.global_batch, shape.seq_len)


def params_specs(cfg: ArchConfig):
    lm = LM(cfg, device="cpu")
    with on_meta():
        return lm.init(torch.Generator().manual_seed(0))
