"""The share of the Zamba2 cell's traced window in which no operation ran
on the device: 1 - (the union of the device's operations) / window."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "lm_train_tokens_per_s"


def read(obs, name):
    return 100.0 * (1.0 - obs.busy_s / obs.window_s)
