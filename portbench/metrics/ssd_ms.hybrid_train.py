"""Device milliseconds a Zamba2 step inside the SSD's entry in
``nn/ssm.py`` (``ssd_chunked``, which the mixer looks up at each call)
and its autograd nodes: the chunked scan's forward, the forward that
``remat="full"`` recomputes, and its backward."""
LAYER = "Mamba-2 mixer (nn/ssm.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"
CALLS = {"repro_torch.nn.ssm:ssd_chunked": (None, True)}


def read(obs, name):
    if not obs.calls[name]:
        return None
    return 1e3 * obs.range_s[name] / obs.units
