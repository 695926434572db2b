"""Host milliseconds a pass inside the program's ``kernels.launch`` spans:
the C launcher call of each kernel proper (``relational_matmul``'s slab or
stream pass, ``fused_sigmoid_matmul``), its ``cudaFuncSetAttribute``
included."""
from portbench import program_spans

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
MOVES = "mlp_rows_per_s"


def read(obs, name):
    return program_spans.host_ms(obs, "kernels.launch", "nn2sql.iteration")
