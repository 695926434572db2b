"""The least time of the calls to ``RelTensor.matmul`` (the join and
group-by; its operations and bytes from the relations handed to it) over
the device time inside them."""
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "mlp_rows_per_s"
CALLS = {"repro_torch.core.relational:RelTensor.matmul":
         ("relmm_relation", False)}


def read(obs, name):
    return obs.roofline(name)
