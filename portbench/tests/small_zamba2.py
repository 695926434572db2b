"""The Zamba2 cell shrunk to a size a CPU test run holds: hidden 256, 4
attention heads of 2d / 4 = 128, 32 Mamba-2 heads of 16 in two groups,
chunks of 16 in a sequence of 64, adapters of rank 8, a 6-layer stack
whose uses 1, 2, 4, 5 take the blocks A, B, A, B.  The limits are set at
the cell's own size, where bf16's rounding averages over wider sums: here
sound runs read `grad_gap` 0.0066 (seeds 5 and 6, which the tests use) to
0.019 (seed 7) against the cell's 0.015 and 0.0075 there, so a run at this
size on another seed can fail on rounding alone; `grad_sample_gap` reads
0.16-0.18 here against 0.08-0.10 at the cell's size, under its 0.26."""
HYBRID = [1, 2, 4, 5]
ZAMBA2 = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=4,
              attention_head_dim=128, attention_hidden_size=512,
              kv_channels=64, mamba_headdim=16, n_mamba_heads=32,
              mamba_d_state=16, chunk_size=16, intermediate_size=512,
              ffn_hidden_size=512, adapter_rank=8, vocab_size=512,
              num_hidden_layers=6, hybrid_layer_ids=HYBRID,
              layers_block_type=["hybrid" if i in HYBRID else "mamba"
                                 for i in range(6)])
ZAMBA2_TRAFFIC = dict(seq_len=64, global_batch=4, microbatches=2)


def resize(cell) -> None:
    cell.config.update(ZAMBA2)
    cell.traffic.update(ZAMBA2_TRAFFIC)
