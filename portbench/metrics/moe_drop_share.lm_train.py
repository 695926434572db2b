"""The share of the MoE's token-to-expert assignments dropped past their
expert's capacity over the traced window: the program's counters
``moe.dropped`` over ``moe.assignments`` (each forward counted once,
not the one ``remat`` recomputes)."""
from portbench import program_spans

LAYER = "the whole step (train/trainer.py)"
UNIT = "%"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.counter_share("moe.dropped", "moe.assignments",
                                       "train.step")
