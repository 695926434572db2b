"""Host milliseconds a step inside the program's ``kernels.status_wait``
spans: ``moe_dispatch``'s launch-and-wait and ``relational_matmul``'s
first pass and wait, forward, recompute and backward."""
from portbench import program_spans

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return program_spans.host_ms(obs, "kernels.status_wait", "train.step")
