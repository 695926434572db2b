"""The share of the elements that AdamW's updates on the card touched in
a Zamba2 step that went through the fused kernel: the counters
``optim.fused`` over ``optim.elems``, as ``optim_fused_share.lm_train``
reads them; none where the program has no such counter."""
from portbench import program_spans

LAYER = "optimizer (optim/optimizers.py, the clip in train/trainer.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.counter_share("optim.fused", "optim.elems",
                                       "train.step")
