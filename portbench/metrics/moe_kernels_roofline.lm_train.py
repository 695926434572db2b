"""The least time of the calls to ``ops.moe_dispatch`` and
``ops.relational_matmul`` (the MoE's join and group-by) and of their
backward (the transposed products and ``tuple_dot``), from their
operands, over the device time inside them and their autograd nodes."""
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"
CALLS = {"repro_torch.kernels.ops:moe_dispatch": ("moe_dispatch", True),
         "repro_torch.kernels.ops:relational_matmul":
         ("relational_matmul", True)}


def read(obs, name):
    return obs.roofline(name)
