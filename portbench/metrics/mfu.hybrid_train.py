"""The Zamba2 training step's model FLOPs in the traced window (6 x the
parameters a token's products touch, causal attention at (224, 224) and
the SSD's own products, each forward and backward; no recompute:
``zamba2_counts``) over the window at the bf16 tensor-core price."""
from portbench import peaks

LAYER = "the whole step (train/trainer.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return 100.0 * obs.model_flops / (obs.window_s * peaks.BF16_FLOPS)
