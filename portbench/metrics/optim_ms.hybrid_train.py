"""Device milliseconds a Zamba2 step inside the gradient clip
(``clip_by_global_norm`` as the trainer calls it) and
``Optimizer.update`` (AdamW's in-place passes over the float32 state):
the calls that ``optim_ms.lm_train`` reads."""
LAYER = "optimizer (optim/optimizers.py, the clip in train/trainer.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"
CALLS = {"repro_torch.train.trainer:clip_by_global_norm": (None, False),
         "@optimizer.update": (None, False)}


def read(obs, name):
    if not obs.calls[name]:
        return None
    return 1e3 * obs.range_s[name] / obs.units
