"""Multi-tenant in-database serving: one plan, B requests (PyTorch port of
``repro.serving.db_serve``).

The dense :class:`repro_torch.serving.engine.ServingEngine` does continuous
batching over a decode step on the card; this module gives ``SQLEngine`` the
same shape (the "millions of users" direction — the unit of
scaling becomes requests-per-plan, not queries-per-request):

* a :class:`repro_torch.db.adapter.ConnectionPool` of worker adapters over ONE
  logical database (sqlite WAL one-writer/many-readers, duckdb
  cursor-per-worker),
* an async request queue with a **micro-batching window**: the dispatcher
  blocks on the first request, then gathers arrivals for ``window_ms``
  (up to ``max_batch``) and evaluates the whole group as ONE batched
  query — ``SQLEngine.evaluate_batched`` folds the ``b`` request-index
  column through the cached plan, so a group of any size rides the same
  rendered SQL,
* per-request ``concurrent.futures.Future`` results and per-tenant
  ``serve.*`` metric points on the ambient tracer.

Request leaves batch per group; shared leaves (weights) are ingested into
every pool worker once at :meth:`SQLBatchServer.start` and skipped by
content digest afterwards.  Leaves may be tensors on any device: they cross
to the host (:func:`repro_torch.device.to_host`) in ``__init__`` and
``submit``, on the caller's thread, never inside a worker; results are
numpy float64 arrays, as ``SQLEngine.evaluate`` returns them.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..core import expr as E
from ..db.adapter import ConnectionPool
from ..db.sql_engine import SQLEngine
from ..device import to_host
from ..obs import tracer_of

#: dispatcher default: how long the gatherer waits for co-batchable
#: arrivals after the first request of a group (milliseconds)
WINDOW_MS = 2.0

#: dispatcher default: largest request group one query evaluates
MAX_BATCH = 16

_STOP = object()


@dataclass
class _Pending:
    """One queued request: its per-request leaves and the future the
    caller is waiting on."""
    leaves: dict
    future: Future
    tenant: str | None
    t_enqueued: float = field(default_factory=time.perf_counter)


class SQLBatchServer:
    """Micro-batching request front over a pool of in-DB engines.

    ``roots`` fixes the served DAG; ``batch_vars`` names the leaves that
    vary per request (everything else is shared and supplied via
    ``shared_env``).  ``submit`` returns a Future resolving to one dense
    array per root for THAT request — results are split back out of the
    batched stacks, so callers never see each other.

    Knobs: ``pool_size`` workers (each its own connection + dispatcher
    thread), ``window_ms`` gather window, ``max_batch`` group cap.
    """

    def __init__(self, roots: Sequence[E.Expr], batch_vars: Sequence[str],
                 shared_env: dict, backend: str = "sqlite",
                 path: str = ":memory:", pool_size: int = 2,
                 window_ms: float = WINDOW_MS, max_batch: int = MAX_BATCH,
                 dialect=None, plan_cache_=None):
        self.roots = list(roots)
        self.batch_vars = tuple(sorted(batch_vars))
        free = {v.name for v in E.free_vars(*self.roots)}
        unknown = set(self.batch_vars) - free
        if unknown:
            raise KeyError(f"batch_vars not free in the DAG: "
                           f"{sorted(unknown)}")
        missing = free - set(self.batch_vars) - set(shared_env)
        if missing:
            raise KeyError(f"shared_env missing leaves: {sorted(missing)}")
        self.shared_env = {k: to_host(v, dtype=None)
                           for k, v in shared_env.items()}
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.pool = ConnectionPool(backend, path, size=pool_size)
        self.engines = [SQLEngine(adapter=a, dialect=dialect,
                                  plan_cache_=plan_cache_)
                        for a in self.pool]
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._stopping = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "SQLBatchServer":
        """Ingest the shared leaves into every worker (a ``:memory:``
        sqlite pool is N independent databases; file/duckdb pools skip
        all but the first by shared digest) and launch one dispatcher
        thread per worker."""
        if self._started:
            return self
        for eng in self.engines:
            eng._write_env(self.roots, self.shared_env,
                           names=set(self.shared_env))
        for k, eng in enumerate(self.engines):
            t = threading.Thread(target=self._worker_loop, args=(eng,),
                                 name=f"sql-serve-{k}", daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def stop(self) -> None:
        if not self._started or self._stopping:
            return
        self._stopping = True
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join(timeout=30)
        self.pool.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- requests -----------------------------------------------------------
    def submit(self, leaves: dict, tenant: str | None = None) -> Future:
        """Enqueue one request.  ``leaves`` maps every name in
        ``batch_vars`` to that request's matrix; the Future resolves to
        ``[array per root]`` (each of the root's own unbatched shape)."""
        if not self._started:
            raise RuntimeError("server not started — call start()")
        if set(leaves) != set(self.batch_vars):
            raise KeyError(f"request leaves {sorted(leaves)} != "
                           f"batch_vars {list(self.batch_vars)}")
        p = _Pending({k: to_host(v) for k, v in leaves.items()}, Future(),
                     tenant)
        tracer_of(self).inc("serve.db_submitted")
        self._q.put(p)
        return p.future

    def __call__(self, leaves: dict, tenant: str | None = None):
        """Synchronous convenience: submit and wait."""
        return self.submit(leaves, tenant=tenant).result()

    # -- dispatcher ---------------------------------------------------------
    def _gather(self) -> list[_Pending] | None:
        """Block for the first request, then collect co-batchable arrivals
        until the window closes or the group is full.  None → shut down
        (the stop sentinel is re-queued so sibling workers see it too)."""
        first = self._q.get()
        if first is _STOP:
            return None
        group = [first]
        deadline = time.perf_counter() + self.window_ms / 1e3
        while len(group) < self.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is _STOP:
                self._q.put(_STOP)   # sibling dispatchers still need it
                break
            group.append(nxt)
        return group

    def _worker_loop(self, eng: SQLEngine) -> None:
        tr = tracer_of(self)
        while True:
            group = self._gather()
            if group is None:
                return
            t0 = time.perf_counter()
            try:
                batch_env = {
                    name: np.stack([p.leaves[name] for p in group])
                    for name in self.batch_vars}
                outs = eng.evaluate_batched(self.roots, self.shared_env,
                                            batch_env)
            except Exception as exc:
                for p in group:
                    if not p.future.cancelled():
                        p.future.set_exception(exc)
                tr.inc("serve.db_failed", len(group))
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            tr.inc("serve.db_batches")
            tr.inc("serve.db_requests", len(group))
            tr.observe("serve.db_batch_size", len(group))
            tr.observe("serve.db_batch_ms", dt_ms)
            now = time.perf_counter()
            for k, p in enumerate(group):
                req_ms = (now - p.t_enqueued) * 1e3
                tr.observe("serve.db_request_ms", req_ms)
                tr.observe("serve.db_queue_ms", (t0 - p.t_enqueued) * 1e3)
                if p.tenant is not None:
                    tr.point("serve.db_request_ms", req_ms, tenant=p.tenant)
                if not p.future.cancelled():
                    p.future.set_result([out[k] for out in outs])
