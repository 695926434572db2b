"""Run a real MoE layer and the RWKV recurrences entirely inside sqlite.

The §8 outlook made concrete: the same expression DAGs the port's engines
execute are rendered to one WITH query each (window-function top-k,
GROUP-BY reductions, index-relation joins, a recursive-CTE scan) and
executed by the database — then checked against the plain PyTorch
references (``kernels/ref.py``, ``db.zoo``'s oracles), which run on
``--device``.  The RWKV-6 head here has N = 4, a width the card's
``rwkv6_scan`` kernel does not take, so its oracle is the plain
recurrence, as in the reference script.

    PYTHONPATH=src python -m repro_torch.examples.zoo_in_db [--backend duckdb]
    PYTHONPATH=src python -m repro_torch.examples.zoo_in_db --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import sqlgen
from ..db import zoo
from ..db.sql_engine import SQLEngine
from ..device import resolve, to_host
from ..kernels import ref


def zoo_checks(backend: str, device, show_sql: bool = False) -> dict:
    """Each zoo function in the database against its oracle on ``device``,
    on inputs from ``RandomState(0)``; the largest differences, printed,
    and the in-database MoE gradients."""
    rng = np.random.RandomState(0)

    # -- MoE: route → per-expert SwiGLU → gated combine, all in-DB --------
    cfg = zoo.MoESQLConfig(n_tokens=16, d_model=8, n_experts=4, top_k=2,
                           d_ff=16)
    params = zoo.init_moe_params(cfg)
    x = rng.randn(cfg.n_tokens, cfg.d_model).astype(np.float32)
    out_db = zoo.run_moe_in_db(cfg, params, x, backend=backend)
    out_ref = zoo.moe_ffn_ref(cfg, params, x, device=device)
    moe = float(np.abs(out_db - out_ref).max())
    print(f"MoE({cfg.n_tokens} tok, {cfg.n_experts} experts, "
          f"top-{cfg.top_k}) in {backend}: max|Δ| vs torch = {moe:.2e}")

    if show_sql:
        graph = zoo.moe_ffn_graph(cfg)
        print(sqlgen.to_sql92([graph.gates], dialect=backend))

    # -- RWKV-6 time mix: the N²-state scan as ONE recursive CTE ----------
    s, n = 12, 4
    r, k, v = [rng.randn(s, n).astype(np.float32) * 0.5 for _ in range(3)]
    w = (rng.rand(s, n) * 0.5 + 0.3).astype(np.float32)
    u = (rng.randn(n) * 0.5).astype(np.float32)
    s0 = (rng.randn(n, n) * 0.3).astype(np.float32)
    o_db, sfin_db = zoo.run_rwkv6_in_db(r, k, v, w, u, s0, backend=backend)
    o_ref, sfin_ref = ref.rwkv6_scan(
        *(torch.as_tensor(a[None], device=device) for a in (r, k, v, w, u,
                                                            s0)))
    rwkv_o = float(np.abs(to_host(o_ref[0]) - o_db).max())
    rwkv_s = float(np.abs(to_host(sfin_ref[0]) - sfin_db).max())
    print(f"RWKV-6 time mix (S={s}, N={n}) in {backend}: "
          f"max|Δo| = {rwkv_o:.2e}, max|ΔS| = {rwkv_s:.2e}")

    # -- RWKV channel mix: token shift + relu² FFN ------------------------
    d, f = 6, 12
    xc = rng.randn(s, d).astype(np.float32)
    mu_k, mu_r = rng.rand(d), rng.rand(d)
    wk, wv, wr = (rng.randn(d, f) * .3, rng.randn(f, d) * .3,
                  rng.randn(d, d) * .3)
    cm_db = zoo.run_channel_mix_in_db(xc, mu_k, mu_r, wk, wv, wr,
                                      backend=backend)
    cm_ref = zoo.rwkv_channel_mix_ref(xc, mu_k, mu_r, wk, wv, wr)
    channel_mix = float(np.abs(cm_db - cm_ref).max())
    print(f"RWKV channel mix in {backend}: max|Δ| = {channel_mix:.2e}")

    # -- gradients: Algorithm 1 over the zoo nodes, executed in-DB --------
    graph = zoo.moe_ffn_graph(cfg)
    eng = SQLEngine(backend=backend)
    try:
        vg = eng.value_and_grad_fn(graph.out, list(graph.weight_vars))
        loss, grads = vg(zoo.moe_env(cfg, params, x))
    finally:
        eng.close()
    router = float(np.abs(grads["w_router"]).max())
    print(f"in-DB MoE gradients: {len(grads)} weight tables, "
          f"|∂router| max = {router:.3f}")
    return dict(moe=moe, rwkv_o=rwkv_o, rwkv_s=rwkv_s,
                channel_mix=channel_mix, loss=loss, grads=grads,
                grad_tables=len(grads), router_max=router)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="sqlite",
                    choices=["sqlite", "duckdb"])
    ap.add_argument("--show-sql", action="store_true",
                    help="print the rendered MoE routing query")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return zoo_checks(args.backend, resolve(args.device), args.show_sql)


if __name__ == "__main__":
    main()
