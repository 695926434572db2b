"""Device allocations (``cudaMalloc`` calls of PyTorch's caching
allocator) a pass: the ``cuda_mallocs`` attribute of the program's
``nn2sql.iteration`` spans, the allocator's ``num_device_alloc`` over
each iteration."""
from portbench import program_spans

LAYER = "the whole pass (core/nn2sql)"
UNIT = "count"
BETTER = "lower"
MOVES = "mlp_rows_per_s"


def read(obs, name):
    return program_spans.attr_sum(obs, "nn2sql.iteration", "cuda_mallocs",
                                  "nn2sql.iteration")
