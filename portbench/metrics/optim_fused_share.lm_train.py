"""The share of the elements that AdamW's updates on the card touched
that went through the fused kernel (``kernels/adamw.py``): the program's
counters ``optim.fused`` over ``optim.elems``.  Every CUDA leaf takes the
kernel or raises, so it should read 100: the proof that the step's
optimizer tail runs fused; none where the program has no such counter."""
from portbench import program_spans

LAYER = "optimizer (optim/optimizers.py, the clip in train/trainer.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.counter_share("optim.fused", "optim.elems",
                                       "train.step")
