"""Cells shrunk to sizes a CPU test run holds, widths kept in ratio."""
MLP = dict(n_rows=256, n_features=32, n_hidden=16, n_classes=4, lr=0.6 / 256)
DEEPSEEK = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                n_routed_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=32, n_shared_experts=1,
                intermediate_size=96, vocab_size=256, num_hidden_layers=3)
DEEPSEEK_TRAFFIC = dict(seq_len=64, global_batch=4, microbatches=2)


def resize(cell) -> None:
    if cell.traffic["driver"] == "mlp":
        cell.config.update(MLP)
    else:
        cell.config.update(DEEPSEEK)
        cell.traffic.update(DEEPSEEK_TRAFFIC)
