"""Device milliseconds a Zamba2 step inside the shared blocks' uses
(``LM._zamba2_shared``: norm, attention, the gated MLP with the use's
adapter and the use's linear) and their autograd nodes, forward,
recompute and backward; none where the program has no such method."""
LAYER = "Zamba2 shared blocks (nn/model.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"
CALLS = {"repro_torch.nn.model:LM._zamba2_shared": (None, True)}


def read(obs, name):
    if not obs.calls[name]:
        return None
    return 1e3 * obs.range_s[name] / obs.units
