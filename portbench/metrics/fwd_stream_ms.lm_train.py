"""Milliseconds a step of the card's stream between the CUDA events that
the program's ``train.forward`` spans record as they open and close (each
microbatch's ``loss_fn``): the forward's device work and whatever idle
the host leaves inside it, so it follows the host's speed too.  Not the
device's busy time inside the span, which the profiler's events would
give."""
from portbench import program_spans

LAYER = "the whole step (train/trainer.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.device_ms(obs, "train.forward", "train.step")
