"""Faults planted in the program underneath a run, through the driver's
``on_built`` hook: each must turn ``correct`` false.  The tests plant
them at a small size on the CPU; ``calibrate.py`` reads them on the card
at the cell's size, where they set the upper readings of the limits."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, attr, new):
    """``obj.attr`` replaced by ``new(obj.attr)`` until the context ends."""
    old = getattr(obj, attr)
    setattr(obj, attr, new(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


class Planted:
    """``on_built`` for a driver: plants ``fault`` and keeps its undo, to
    be closed after the run."""

    def __init__(self, fault: str):
        self.fault = fault
        self.stack = contextlib.ExitStack()

    def __call__(self, objects: dict) -> None:
        self.stack.enter_context(PLANT[self.fault](objects))

    def close(self) -> None:
        self.stack.close()


# -- the MLP -----------------------------------------------------------------

def mlp_unchanged(objects):
    """A training call that returns the weights it was given."""
    return _patched(objects["nn2sql"], "train",
                    lambda train: lambda graph, w, *a, **k: (w, None))


def mlp_half_batch(objects):
    """A training call that leaves out the second half of the rows and
    doubles the step (the summed loss's gradient over the rest, as a mean
    would scale it)."""
    nn2sql = objects["nn2sql"]

    def new(train):
        def half(graph, w, x, y, n, engine, **k):
            s = graph.spec
            h = s.n_rows // 2
            g = nn2sql.build_graph(nn2sql.MLPSpec(
                h, s.n_features, s.n_hidden, s.n_classes, lr=2 * s.lr))
            return train(g, w, x[:h], y[:h], n, engine, **k)
        return half
    return _patched(nn2sql, "train", new)


# -- LM training ---------------------------------------------------------------

def lm_unchanged(objects):
    """A step that computes the loss as the step does (the mean over its
    microbatches) and returns its state unchanged."""
    trainer, model = objects["trainer"], objects["model"]
    n = objects["microbatches"]

    def new(step):
        def same(params, opt_state, batch):
            rows = next(iter(batch.values())).shape[0] // n
            with torch.no_grad():
                loss = sum(model.loss_fn(params, {
                    k: v[i * rows:(i + 1) * rows] for k, v in batch.items()
                })[0] for i in range(n)) / n
            return params, opt_state, {"loss": loss}
        return same
    return _patched(trainer, "step_fn", new)


def lm_half_batch(objects):
    """A step on the first half of the batch's rows alone, its loss and
    gradient the mean over them."""
    def new(step):
        def half(params, opt_state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(params, opt_state,
                        {k: v[:rows] for k, v in batch.items()})
        return half
    return _patched(objects["trainer"], "step_fn", new)


PLANT = {
    "mlp_unchanged": mlp_unchanged, "mlp_half_batch": mlp_half_batch,
    "lm_unchanged": lm_unchanged, "lm_half_batch": lm_half_batch,
}

#: the faults each driver's cells can have
FAULTS = {"mlp": ("mlp_unchanged", "mlp_half_batch"),
          "lm_train": ("lm_unchanged", "lm_half_batch")}
