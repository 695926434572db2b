"""Host milliseconds a pass inside the program's ``kernels.status_wait``
spans: the first pass of ``relational_matmul`` that checks the relation
into its status flags, and the host's wait for it (one a call)."""
from portbench import program_spans

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
MOVES = "mlp_rows_per_s"


def read(obs, name):
    return program_spans.host_ms(obs, "kernels.status_wait",
                                 "nn2sql.iteration")
