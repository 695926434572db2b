"""Twins of ``repro.checkpoint`` for the port: the round trip, GC to
``keep``, the atomic publish, the synchronous snapshot behind the async
write, and checkpoints that cross between the two packages in both
directions (the same layout, leaves numbered in JAX's order)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.optim import adamw
from repro_torch.tree import leaves


def params_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"layers": {"wq": rng.randn(2, 4, 6).astype(np.float32),
                       "norm": rng.randn(2, 4).astype(np.float32)},
            "embed": rng.randn(10, 4).astype(np.float32)}


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0), "b": {"c": torch.ones((2, 2))},
            "t": torch.tensor(3, dtype=torch.int32),
            "h": torch.linspace(-1, 1, 5).to(torch.bfloat16)}
    for step in (1, 2, 3):
        ck.save(step, tree, blocking=True)
    assert ck.list_steps() == [2, 3]          # gc keeps 2
    restored, step = ck.restore(tree)
    assert step == 3
    for k in ("a", "t", "h"):
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    restored, step = ck.restore(tree, step=2)
    assert step == 2
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["n_leaves"] == 4
    assert manifest["dtypes"] == ["float32", "float32", "bfloat16", "int32"]


def test_publish_is_atomic(tmp_path):
    """A step is listed only once its directory was moved into place with
    its manifest: a leftover ``.tmp`` (a crash mid-write) is not a step,
    and no ``.tmp`` stays after a save."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000008").mkdir()           # no manifest
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"a": torch.zeros(1)})
    ck.save(4, {"a": torch.zeros(1)}, blocking=True)
    assert ck.list_steps() == [4]
    assert not (tmp_path / "step_00000004.tmp").exists()
    ck.save(4, {"a": torch.ones(1)}, blocking=True)   # re-save: idempotent
    assert float(ck.restore({"a": torch.zeros(1)})[0]["a"]) == 0.0


def test_save_snapshots_before_it_returns(tmp_path):
    """The caller may update its tensors in place right after ``save``:
    the write thread reads the host copy made before ``save`` returned."""
    ck = Checkpointer(str(tmp_path))
    t = {"w": torch.arange(1000.0)}
    ck.save(1, t)
    t["w"].add_(1.0)
    ck.wait()
    assert torch.equal(ck.restore(t)[0]["w"], torch.arange(1000.0))


def test_restore_checks_shapes_and_places_by_example(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2, 3)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.ones(3, 2)})
    out, _ = ck.restore({"w": torch.zeros(2, 3, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """(params, adamw state) written by ``repro.checkpoint.Checkpointer``
    after a JAX update comes back leaf for leaf in the port."""
    jp = jax.tree.map(jnp.asarray, params_tree(0))
    jopt = jadamw(1e-2)
    jst = jopt.init(jp)
    jp, jst = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, params_tree(1)),
                                   jst, jp)
    JCheckpointer(str(tmp_path)).save(7, (jp, jst), blocking=True)

    params = convert.from_jax_params(params_tree(5), device="cpu")
    state = adamw(1e-2).init(params)
    (rp, rst), step = Checkpointer(str(tmp_path)).restore((params, state))
    assert step == 7
    assert int(rst["t"]) == 1 and rst["t"].dtype == torch.int32
    for a, b in zip(leaves((rp, rst)), jax.tree.leaves((jp, jst))):
        equal(a.numpy(), b)


def test_port_checkpoint_restores_in_jax(tmp_path):
    params = convert.from_jax_params(params_tree(2), device="cpu")
    opt = adamw(1e-2, mixed_precision=True)
    state = opt.init(params)
    params, state = opt.update(
        convert.from_jax_params(params_tree(3), "cpu"), state, params)
    Checkpointer(str(tmp_path)).save(5, (params, state), blocking=True)

    jp = jax.tree.map(jnp.asarray, params_tree(6))
    jst = jadamw(1e-2, mixed_precision=True).init(jp)
    (rp, rst), step = JCheckpointer(str(tmp_path)).restore((jp, jst))
    assert step == 5 and int(rst["t"]) == 1
    for a, b in zip(jax.tree.leaves((rp, rst)), leaves((params, state))):
        equal(a, b.numpy())
    assert os.listdir(tmp_path) == ["step_00000005"]
