"""The port's expert-parallel MoE layer (``nn/moe.py``: ``_moe_sort_local``,
``_moe_shard``, ``set_moe_mesh``) against the JAX package's:

* ``_moe_sort_local`` on each owner's share of a partition of the experts
  equals JAX's ``_moe_sort_local`` on the same numpy inputs (the same
  routing), and the owners' partial sums equal the full relation, at
  ``tests/test_moe.py``'s tolerance (rtol 2e-3, atol 2e-4), with and
  without dropped assignments;
* ``_moe_shard`` on a 4-rank gloo group on the CPU, a (data 1, model 4)
  mesh, equals the sum of JAX's four partials, on every rank; and through
  ``moe_ffn(impl="shard")`` once the mesh is installed.
"""
from __future__ import annotations

import dataclasses
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.nn.layers as JL
import repro.nn.moe as JM
import repro_torch.nn.layers as TL
from repro_torch import convert
from repro_torch.nn import moe as TM

TOL = dict(rtol=2e-3, atol=2e-4)                # tests/test_moe.py
WORLD = 4


@pytest.fixture(autouse=True)
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def make(t=40, d=16, e=8, k=2, ff=32, cf=1.25, seed=5):
    fields = dict(n_experts=e, top_k=k, d_model=d, d_ff=ff,
                  capacity_factor=cf)
    jcfg = JM.MoEConfig(impl="sort", **fields)
    tcfg = TM.MoEConfig(impl="sort", **fields)
    import jax
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.RandomState(seed).randn(t, d).astype(np.float32)
    return jcfg, tcfg, jp, convert.from_jax_params(jp, device="cpu"), x


def jax_partials(jcfg, jp, x, owners):
    """JAX's partial of each owner of ``owners`` equal ranges, its routing
    and capacity over all of x's tokens."""
    jx = jnp.asarray(x)
    gates, idx, _ = JM._route(jp, jx, jcfg)
    cap = JM._capacity(x.shape[0], jcfg)
    e_loc = jcfg.n_experts // owners
    parts = [np.asarray(JM._moe_sort_local(
        jp["wi"][lo:lo + e_loc], jp["wg"][lo:lo + e_loc],
        jp["wo"][lo:lo + e_loc], jx, jcfg, gates, idx, lo, e_loc, cap))
        for lo in range(0, jcfg.n_experts, e_loc)]
    return parts, np.array(gates), np.array(idx), cap


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["no_drops", "drops"])
@pytest.mark.parametrize("owners", [1, 2, 4])
def test_sort_local_equals_jax_per_owner(owners, cf):
    jcfg, tcfg, jp, p, x = make(cf=cf)
    parts, gates, idx, cap = jax_partials(jcfg, jp, x, owners)
    e_loc = tcfg.n_experts // owners
    for r, want in enumerate(parts):
        lo = r * e_loc
        got = TM._moe_sort_local(
            p["wi"][lo:lo + e_loc], p["wg"][lo:lo + e_loc],
            p["wo"][lo:lo + e_loc], torch.from_numpy(x), tcfg,
            torch.from_numpy(gates), torch.from_numpy(idx).long(), lo,
            e_loc, cap)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["no_drops", "drops"])
def test_partials_sum_to_the_full_relation(cf):
    """Owners over a partition of the experts sum to the relation over all
    of them: the port's ``_moe_sort_local`` over the full range, and JAX's
    ``_moe_sort_one`` (one group, the same capacity)."""
    jcfg, tcfg, jp, p, x = make(cf=cf)
    _, gates, idx, cap = jax_partials(jcfg, jp, x, 1)
    tx, tg, ti = (torch.from_numpy(x), torch.from_numpy(gates),
                  torch.from_numpy(idx).long())
    full = TM._moe_sort_local(p["wi"], p["wg"], p["wo"], tx, tcfg, tg, ti,
                              0, tcfg.n_experts, cap)
    halves = sum(TM._moe_sort_local(p["wi"][lo:lo + 4], p["wg"][lo:lo + 4],
                                    p["wo"][lo:lo + 4], tx, tcfg, tg, ti,
                                    lo, 4, cap) for lo in (0, 4))
    torch.testing.assert_close(halves, full, **TOL)
    jfull = JM._moe_sort_one(jp, jnp.asarray(x), jcfg, jnp.asarray(gates),
                             jnp.asarray(idx))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)


# ---------------------------------------------------------------------------
# _moe_shard on four gloo ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, port, p, x, cfg, want, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    TL.COMPUTE_DTYPE = torch.float32
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (1, WORLD),
                                mesh_dim_names=("data", "model"))
        TM.set_moe_mesh(mesh, ("data",))
        got = TM._moe_shard(p, torch.from_numpy(x), cfg)
        ffn, _ = TM.moe_ffn(p, torch.from_numpy(x),
                            dataclasses.replace(cfg, impl="shard"))
        err = [float(np.abs(t.numpy() - want).max()) for t in (got, ffn)]
        ok = all(np.allclose(t.numpy(), want, **TOL) for t in (got, ffn))
        with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
            f.write(f"{int(ok)} {err[0]} {err[1]}")
    finally:
        TM.set_moe_mesh(None, None)
        dist.destroy_process_group()


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["no_drops", "drops"])
def test_moe_shard_on_four_gloo_ranks_equals_jax(cf, tmp_path):
    """Every rank routes all 40 tokens (the data axis has one rank), fills
    its 2 of the 8 experts and sums the four partials with one
    all_reduce over 'model'; the result is JAX's four partials summed."""
    jcfg, tcfg, jp, p, x = make(cf=cf)
    parts, *_ = jax_partials(jcfg, jp, x, WORLD)
    want = sum(parts)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, p, x, tcfg, want,
                                             str(tmp_path)))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(120)
    assert all(pr.exitcode == 0 for pr in procs), \
        [pr.exitcode for pr in procs]
    for r in range(WORLD):
        ok, *errs = (tmp_path / f"rank{r}").read_text().split()
        assert ok == "1", f"rank {r}: max |err| {errs}"
