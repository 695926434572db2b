"""Training loop, PyTorch port of ``repro.train.trainer``: microbatched
gradient accumulation, clipping, the optimizer, checkpoint/restart and
straggler monitoring.

``make_train_step`` builds the step function; ``Trainer`` wraps it with
the operational substrate (fault tolerance, checkpoint cadence, metrics).
Where JAX takes a PRNG key, ``Trainer`` takes a ``torch.Generator``;
where it jits with ``donate_argnums``, the step here updates the
parameters and the optimizer state in place (``donate=False`` copies them
first).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..obs import tracer as obs
from ..optim.optimizers import (Optimizer, apply_grad_scale,
                                 clip_by_global_norm)
from ..tree import leaves, tree_map, unflatten


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    grad_accum: int = 1, clip_norm: float = 1.0):
    """loss_fn(params, batch) → (loss, metrics). Returns
    step(params, opt_state, batch) → (params, opt_state, metrics).

    With ``grad_accum > 1`` the global batch is split along axis 0 into
    microbatches, run one after another: activation memory drops by the
    accumulation factor while keeping the same global batch.  Gradients are
    summed in float32 (into the parameters' ``.grad`` where those are
    float32, else into float32 buffers) and divided by ``grad_accum``; the
    loss is averaged; the other metrics are the last microbatch's.  Then
    the gradients are clipped to ``clip_norm`` by their global norm and the
    optimizer updates the parameters in place.  The clip reads the norm of
    the averaged gradients and leaves the division and the clip's factor
    to an optimizer that folds them into its update
    (``Optimizer.folds_grad_scale``: AdamW, one kernel on the card); for
    any other they are applied to the gradients first.  Metrics are 0-dim
    tensors: ``loss``, ``grad_norm`` (of the averaged gradients, before the
    clip) and ``loss_fn``'s own.

    Traced (``repro_torch.obs``), a step is the span ``train.step``
    (attributes ``step``, the call's number, and ``tokens``) with
    ``train.microbatch`` spans around each microbatch's ``train.forward``
    and ``train.backward`` (which holds the forward that activation
    checkpointing recomputes; both carry device time), then
    ``train.clip`` and ``train.update``.
    """
    calls = itertools.count()

    def step(params, opt_state, batch):
        with obs.span("train.step", step=next(calls),
                      tokens=next(iter(batch.values())).numel()):
            return run(params, opt_state, batch)

    def run(params, opt_state, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        tracked = unflatten(params, flat)
        on_grad = all(p.dtype == torch.float32 for p in flat)
        acc = None if on_grad else [torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)
                                    for p in flat]
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch of {n} does not split into "
                             f"{grad_accum} microbatches")
        size = n // grad_accum
        loss_sum = None
        for i in range(grad_accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            with obs.span("train.microbatch", i=i):
                with obs.span("train.forward", device=True):
                    loss, metrics = loss_fn(tracked, micro)
                with obs.span("train.backward", device=True):
                    loss.backward()
            loss = loss.detach().to(torch.float32)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if acc is not None:
                for a, p in zip(acc, flat):
                    if p.grad is not None:
                        a.add_(p.grad)
                        p.grad = None
        if acc is None:
            acc = [p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in flat]
        for p in flat:
            p.grad = None
        if grad_accum > 1:
            loss_sum = loss_sum / grad_accum
        with obs.span("train.clip"):
            grads, gnorm, scale = clip_by_global_norm(
                unflatten(params, acc), clip_norm, divide_by=grad_accum)
        with obs.span("train.update"):
            if getattr(optimizer, "folds_grad_scale", False):
                params, opt_state = optimizer.update(grads, opt_state, params,
                                                     grad_scale=scale)
            else:
                params, opt_state = optimizer.update(
                    apply_grad_scale(grads, scale), opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss_sum,
                                       grad_norm=gnorm)

    return step


def _synchronize(tree) -> None:
    """Wait for the card the tree lives on, if any."""
    device = leaves(tree)[0].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time tracker. On a real fleet the flag feeds the
    scheduler (preempt/replace the slow host); here the policy is the
    tested artifact: flag any step slower than ``threshold ×`` the running
    median over the trailing window."""

    window: int = 50
    threshold: float = 3.0

    def __post_init__(self):
        self.times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        baseline = sorted(self.times[-self.window:])
        self.times.append(seconds)
        if len(baseline) >= 5:
            median = baseline[len(baseline) // 2]
            if seconds > self.threshold * median:
                self.flagged.append(step)
                return True
        return False


class Trainer:
    """Checkpointed, straggler-aware training driver."""

    def __init__(self, model, optimizer: Optimizer, data,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, grad_accum: int = 1,
                 clip_norm: float = 1.0, donate: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        step = make_train_step(model.loss_fn, optimizer, grad_accum,
                               clip_norm)
        if donate:
            self.step_fn = step
        else:
            copy = lambda t: tree_map(torch.clone, t)
            self.step_fn = lambda p, s, b: step(copy(p), copy(s), b)
        self.ckpt = (Checkpointer(checkpoint_dir)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []

    def init_state(self, generator: torch.Generator):
        params = self.model.init(generator)
        return params, self.optimizer.init(params)

    def restore_or_init(self, generator: torch.Generator):
        """Crash-restart entry point: resume from the latest checkpoint if
        one exists, else initialise fresh. The data pipeline is a pure
        function of the step, so the token stream resumes exactly."""
        params, opt_state = self.init_state(generator)
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            (params, opt_state), start = self.ckpt.restore(
                (params, opt_state))
        return params, opt_state, start

    def run(self, generator: torch.Generator, n_steps: int,
            log_every: int = 10, log_fn=print) -> dict:
        params, opt_state, start = self.restore_or_init(generator)
        for step in range(start, n_steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            _synchronize(params)     # the step's last updates included
            dt = time.perf_counter() - t0
            straggle = self.monitor.record(step, dt)
            rec = dict(metrics, step=step, seconds=dt, straggler=straggle)
            self.history.append(rec)
            if log_every and step % log_every == 0:
                log_fn(f"step {step:5d} loss {metrics['loss']:.4f} "
                       f"({dt * 1e3:.0f} ms){' STRAGGLER' if straggle else ''}")
            if self.ckpt and (step + 1) % self.checkpoint_every == 0:
                self.ckpt.save(step + 1, (params, opt_state))
        if self.ckpt:
            self.ckpt.save(n_steps, (params, opt_state), blocking=True)
        return {"params": params, "opt_state": opt_state,
                "history": self.history}
