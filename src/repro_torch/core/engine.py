"""Unified engine interface over the representations (PyTorch port of
``repro.core.engine``).

``Engine("dense")``      — the array-data-type backend (paper Section 5).
``Engine("relational")`` — the SQL-92 relational backend (paper Section 4).
``Engine("sql")``        — the *in-database* backend: the same DAG rendered
                           as SQL and executed by sqlite/duckdb
                           (:mod:`repro_torch.db.sql_engine`).

All three evaluate the same expression DAG; gradients come from Algorithm 1
(``core.autodiff``), *not* ``torch.autograd`` — autograd is used only as a
test oracle.  PyTorch runs eagerly, so the ``*_fn`` builders return plain
callables where the JAX package returns ``jax.jit`` functions.  The SQL
backend's results are numpy float64 arrays, as the database computed them;
tensors cross to it through :func:`repro_torch.device.to_host`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve, to_host
from ..obs import tracer as obs
from . import autodiff, dense, expr as E, rel_engine
from .relational import RelTensor

KINDS = ("dense", "relational", "sql")


class Engine:
    def __init__(self, kind: str, device="cuda", **db_opts):
        """``db_opts`` (``backend=``, ``path=``, ``dialect=`` …) reach
        :class:`repro_torch.db.sql_engine.SQLEngine` when ``kind == "sql"``.
        ``device`` is where the tensor engines run and where
        ``nn2sql.train`` puts the weights the database trained."""
        if kind not in KINDS:
            raise ValueError(f"unknown engine kind {kind!r}; have {KINDS}")
        if db_opts and kind != "sql":
            raise ValueError(f"db options {sorted(db_opts)} only apply to "
                             f"Engine('sql')")
        self.kind = kind
        self.device = resolve(device)
        self._sql = None
        if kind == "sql":
            from ..db.sql_engine import SQLEngine  # lazy: core ↛ db cycle

            self._sql = SQLEngine(**db_opts)

    # -- representation conversion ------------------------------------------
    def lift(self, x):
        """A leaf (tensor or array) on the engine's device, pivoted into a
        RelTensor for the relational engine."""
        x = torch.as_tensor(x, device=self.device)
        return RelTensor.from_dense(x) if self.kind == "relational" else x

    def lower(self, x) -> torch.Tensor:
        return x.to_dense() if isinstance(x, RelTensor) else x

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, roots: list[E.Expr], env: dict):
        with obs.span("engine.evaluate", kind=self.kind):
            if self.kind == "sql":
                return self._sql.evaluate(roots, env)
            ev = (rel_engine.evaluate if self.kind == "relational"
                  else dense.evaluate)
            return ev(roots, env, self.device)

    def eval_fn(self, roots: list[E.Expr]) -> Callable:
        """Evaluator: env dict (dense tensors or arrays) → dense outputs.
        For the SQL backend the query is rendered once and executed per
        call (the database is the executor)."""
        if self.kind == "sql":
            return self._sql.eval_fn(roots)

        def fn(env: dict) -> list[torch.Tensor]:
            lifted = {k: self.lift(v) for k, v in env.items()}
            return [self.lower(o) for o in self.evaluate(roots, lifted)]

        return fn

    def value_and_grad_fn(self, loss: E.Expr, wrt: list[E.Var]) -> Callable:
        """fn: env → (loss value, {var name: gradient}) via Algorithm 1."""
        if self.kind == "sql":
            return self._sql.value_and_grad_fn(loss, wrt)
        grads = autodiff.gradients(loss, wrt)
        roots = [loss] + [grads[v] for v in wrt]

        def fn(env: dict):
            lifted = {k: self.lift(v) for k, v in env.items()}
            outs = self.evaluate(roots, lifted)
            loss_val = self.lower(outs[0])
            return loss_val, {v.name: self.lower(g)
                              for v, g in zip(wrt, outs[1:])}

        return fn

    def close(self) -> None:
        if self._sql is not None:
            self._sql.close()


def sgd_step_fn(loss: E.Expr, wrt: list[E.Var], lr: float, engine: Engine
                ) -> Callable:
    """One gradient-descent update — the recursive step of Listing 7/10:
    ``select iter+1, w.v - γ·d_w.v from w_, d_w where …``."""
    vg = engine.value_and_grad_fn(loss, wrt)

    if engine.kind == "sql":
        # every forward/backward evaluation runs in the database; the
        # weight update mirrors Listing 7's final select on the host
        def sql_step(weights, data_env):
            env = {**weights, **data_env}
            loss_val, grads = vg(env)
            new_w = {k: to_host(weights[k]) - lr * grads[k] for k in weights}
            return new_w, float(np.mean(loss_val))

        return sql_step

    def step(weights: dict[str, torch.Tensor],
             data_env: dict[str, torch.Tensor]):
        env = {**weights, **data_env}
        loss_val, grads = vg(env)
        new_w = {k: weights[k] - lr * grads[k] for k in weights}
        return new_w, loss_val.mean()

    return step
