"""The DAG zoo in SQL (paper §8 outlook; PyTorch port of ``repro.db.zoo``).

Transpilers from the marquee non-MLP kernels to executable SQL over the
zoo IR tier (``core.expr``: RowReduce / Softmax / ArgTopK / Gather /
Scatter / RowShift / Recurrence):

* :mod:`~repro_torch.db.zoo.moe_to_sql` — top-k gated MoE routing,
  dispatch and combine (``kernels/moe_dispatch.py`` / ``nn/moe.py``
  semantics);
* :mod:`~repro_torch.db.zoo.rwkv_to_sql` — the RWKV-6 time-mix recurrence
  as a recursive CTE and the token-shift channel mix
  (``kernels/rwkv6_scan.py`` semantics);
* :mod:`~repro_torch.db.zoo.ssm_to_sql` — state-space models: the
  SSD/Mamba-2 scalar-decay matrix-state scan (kron-flattened, chunked
  execution) and the LRU/S5 layer over the matrix-valued
  ``MatRecurrence`` (``nn/ssm.py`` semantics).

Every graph is an ordinary expression DAG: Algorithm-1 autodiff, all
four dialects, the plan cache and ``SQLEngine`` apply unchanged.
"""
from .moe_to_sql import (MoESQLConfig, init_moe_params, moe_combine_graph,
                         moe_dispatch_graph, moe_env, moe_env_batched,
                         moe_ffn_graph, moe_ffn_graph_batched, moe_ffn_ref,
                         router_graph, run_moe_in_db)
from .rwkv_to_sql import (kron_index_relations, run_channel_mix_in_db,
                          run_rwkv6_in_db, rwkv6_env, rwkv6_static_env,
                          rwkv6_time_mix_graph, rwkv_channel_mix_graph,
                          rwkv_channel_mix_ref)
from .ssm_to_sql import (lru_env, lru_grads_in_db, lru_layer_graph, lru_ref,
                         run_lru_in_db, run_ssd_in_db, ssd_env,
                         ssd_kron_relations, ssd_ref, ssd_scan_graph,
                         ssd_static_env)

__all__ = [
    "MoESQLConfig", "init_moe_params", "moe_ffn_graph", "moe_env",
    "moe_ffn_graph_batched", "moe_env_batched",
    "moe_ffn_ref", "moe_dispatch_graph", "moe_combine_graph",
    "router_graph", "run_moe_in_db",
    "kron_index_relations", "rwkv6_time_mix_graph", "rwkv6_env",
    "rwkv6_static_env", "run_rwkv6_in_db", "rwkv_channel_mix_graph",
    "rwkv_channel_mix_ref", "run_channel_mix_in_db",
    "ssd_kron_relations", "ssd_scan_graph", "ssd_static_env", "ssd_env",
    "ssd_ref", "run_ssd_in_db", "lru_layer_graph", "lru_env", "lru_ref",
    "run_lru_in_db", "lru_grads_in_db",
]
