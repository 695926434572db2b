"""The share of a training step's ``relational_matmul`` calls (the MoE's
combine and its backward) that took the long-segment schedule ``kslab``:
the program's counters ``relmm.kslab`` over ``relmm.calls``.  Every call
there has segments of a few tuples, so it should read 0: the proof that
the step bypasses the schedule; none where the program has no such
counter."""
from portbench import program_spans

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.counter_share("relmm.kslab", "relmm.calls",
                                       "train.step")
