"""Host milliseconds a Zamba2 step inside the program's ``ssm.ssd``
spans (forward, recompute): the cost of Python issuing the SSD's launches
one at a time, which the device's time does not show; none where the
program keeps no such span."""
from portbench import program_spans

LAYER = "Mamba-2 mixer (nn/ssm.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.host_ms(obs, "ssm.ssd", "train.step")
