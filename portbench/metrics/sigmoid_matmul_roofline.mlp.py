"""The least time of the dense engine's ``Map(SIGMOID, MatMul)`` calls,
``ops.fused_sigmoid_matmul`` (operations and bytes from its operands),
over the device time inside them."""
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "mlp_rows_per_s"
CALLS = {"repro_torch.kernels.ops:fused_sigmoid_matmul":
         ("sigmoid_matmul", False)}


def read(obs, name):
    return obs.roofline(name)
