"""Device milliseconds a pass inside ``RelTensor.from_dense`` and
``RelTensor.transpose``: the relational engine's pivot of a dense matrix
into the relation, and the re-sort of a transposed relation."""
LAYER = "relational engine (core/relational.py, core/rel_engine.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "mlp_rows_per_s"
CALLS = {
    "repro_torch.core.relational:RelTensor.from_dense": (None, False),
    "repro_torch.core.relational:RelTensor.transpose": (None, False),
}


def read(obs, name):
    if not obs.calls[name]:
        return None
    return 1e3 * obs.range_s[name] / obs.units
