"""The MLP's model FLOPs in the traced window (6 a weight and row an
iteration) over the window at the float32 tensor-core price."""
from portbench import peaks

LAYER = "the whole pass (core/nn2sql)"
UNIT = "%"
BETTER = "higher"
MOVES = "mlp_rows_per_s"


def read(obs, name):
    return 100.0 * obs.model_flops / (obs.window_s * peaks.F32_FLOPS)
