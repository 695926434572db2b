"""Batched serving engine: prefill + decode with continuous batching,
PyTorch port of ``repro.serving.engine``.

Model inference is the paper's second workload (§6.3.2: "inference alone is
worthful inside a database system to avoid data extraction"). The engine
serves a fixed decode batch of slots; finished sequences release their slot
to queued requests (continuous batching). Decode shapes are static —
(B, 1) token + fixed-capacity cache — and the cache lives on the model's
device for the engine's lifetime (``decode_step`` writes into it).

As in the JAX package, every slot decodes at one shared position (the
largest of the active slots'), and a slot's prompt is fed token by token
through ``decode_step``; the bulk path is ``LM.prefill``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..obs import tracer_of


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params, max_len: int, batch_slots: int,
                 temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.slots = batch_slots
        self.temperature = temperature
        self.device = model.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros((batch_slots,), np.int32)
        self.cache = model.init_cache(batch_slots, max_len)
        self.cur_token = np.zeros((batch_slots, 1), np.int32)
        self._decode = model.decode_step
        self._steps = 0            # traced decode steps (metric_points)
        #: optional pinned :class:`repro_torch.obs.Tracer`; ``None`` defers
        #: to the ambient tracer (no-op unless installed)
        self.tracer = None

    # ------------------------------------------------------------- requests
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        tr = tracer_of(self)
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                self.active[slot] = req
                # per-slot prefill: feed prompt tokens through decode_step
                # (one path for every request; the bulk LM.prefill serves
                # a batch that arrives at once)
                with tr.span("serve.prefill", uid=req.uid, slot=slot,
                             prompt_len=len(req.prompt)):
                    for i, tok in enumerate(req.prompt):
                        logits, self.cache = self._decode(
                            self.params, self._slot_batch(slot, int(tok)),
                            self.cache, i)
                tr.inc("serve.admitted")
                tr.inc("serve.prefill_tokens", len(req.prompt))
                self.pos[slot] = len(req.prompt)
                nxt = self._sample(logits[slot, 0])
                req.generated.append(int(nxt))
                self.cur_token[slot, 0] = int(nxt)

    def _tokens(self, t: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(t).to(self.device)}

    def _slot_batch(self, slot: int, tok: int) -> dict:
        t = self.cur_token.copy()
        t[slot, 0] = tok
        return self._tokens(t)

    def _sample(self, logits: torch.Tensor) -> int:
        """Greedy at temperature 0; otherwise a draw from
        softmax(logits / T) with the engine's generator (other bits than
        JAX's ``categorical``, the same distribution)."""
        if self.temperature == 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    # ----------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished requests."""
        tr = tracer_of(self)
        t0 = time.perf_counter()
        with tr.span("serve.step") as sp:
            self._admit()
            n_active = sum(r is not None for r in self.active)
            if not n_active:
                return []
            pos = int(max(self.pos[s] for s, r in enumerate(self.active)
                          if r is not None))
            logits, self.cache = self._decode(
                self.params, self._tokens(self.cur_token), self.cache, pos)
            finished = []
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                nxt = self._sample(logits[slot, 0])
                req.generated.append(nxt)
                self.pos[slot] += 1
                self.cur_token[slot, 0] = nxt
                if (len(req.generated) >= req.max_new_tokens
                        or self.pos[slot] >= self.max_len - 1):
                    req.done = True
                    finished.append(req)
                    self.active[slot] = None
            tr.inc("serve.decode_tokens", n_active)
            if tr.enabled:
                sp.set(active=n_active, finished=len(finished), pos=pos)
                dt = time.perf_counter() - t0
                self._steps += 1
                tr.observe("serve.step_ms", dt * 1e3)
                if dt > 0:
                    tr.point("serve.tokens_per_s", n_active / dt,
                             step=self._steps, active=n_active)
            return finished

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and all(r is None for r in self.active):
                break
        return out
