"""The least time of the calls to ``ops.flash_attention`` (Zamba2's
shared attention at (D, Dv) = (224, 224)) and of their backward, from
their operands (``counts.flash_attention``), over the device time inside
them and their autograd nodes."""
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "lm_train_tokens_per_s"
CALLS = {"repro_torch.kernels.ops:flash_attention": ("flash_attention", True)}


def read(obs, name):
    return obs.roofline(name)
