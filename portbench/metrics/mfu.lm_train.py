"""The training step's model FLOPs in the traced window (6 x the active
parameters a token, plus causal attention forward and backward; no
recompute) over the window at the bf16 tensor-core price."""
from portbench import peaks

LAYER = "the whole step (train/trainer.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return 100.0 * obs.model_flops / (obs.window_s * peaks.BF16_FLOPS)
